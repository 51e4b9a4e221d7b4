"""Rematerialized blocks under the plan-saving policy.

PyTorch counterpart of the JAX models' `nn.remat(Block,
policy=_plan_policy())` (`link_tpu/models/linkunet.py:29-40`,
`linkencoder.py`, `minkunet.py`). A block whose `remat_policy` is set runs
its forward under `torch.utils.checkpoint.checkpoint` (non-reentrant):
autograd keeps none of the tensors that the block's own operations save for
the backward, and rebuilds them in the backward by running the block's
forward again, the *replay*. What the policy names is kept instead, on a
tape that the first forward fills and the replay reads back in the same
order:

  * plans (JAX's `PLAN_TAG`): the conv plans already live in the `kmaps`
    dict that every tensor derived from one input shares, so the replay
    finds them there without a join; the ELK block's aux cells and window
    join (`ops/elk.py`) go on the tape (`saved`);
  * conv outputs (JAX's `CONV_OUT_TAG`, policy `PLANS_AND_CONV_OUTPUTS`):
    `GatherConv` and `WindowConv` tape their output, and in the replay
    rebuild their autograd node but launch no kernel and return the taped
    output; under policy `PLANS` the replay runs the convs again;
  * values the replay must not compute again, whatever the policy: the
    float32 atomic sums (`sparse/ops.segment_sum`), which would round
    otherwise than in the forward that ran, and SyncBN's all-reduce
    (`nn/modules.differentiable_all_reduce`), which would make a step's
    collective calls differ from one without remat.

So the replay recomputes only the BatchNorm / LayerNorm / ReLU segments
between the kept values, equal to the bit to those of the forward, and the
gradient is that of the forward that ran. The replay moves no BatchNorm's
running statistics (`replaying`). The tape holds detached views of the kept
tensors; it lives as long as the step's autograd graph.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional, Tuple, Type

import torch
import torch.utils.checkpoint
from torch import nn

# JAX's save_only_these_names(PLAN_TAG) (minkunet.py:_plan_policy)
PLANS = "plans"
# JAX's save_only_these_names(PLAN_TAG, CONV_OUT_TAG) (linkunet.py and
# linkencoder.py:_plan_policy)
PLANS_AND_CONV_OUTPUTS = "plans_and_conv_outputs"
POLICIES = (PLANS, PLANS_AND_CONV_OUTPUTS)


class _Tape:
    """The values one block's forward keeps for its replay, in call order."""

    def __init__(self, policy: str):
        self.policy = policy
        self.values = []
        self.replaying = False
        self.pos = 0


# the tape of the block whose forward or replay runs in this thread (the
# backward replays a block on autograd's device thread)
_local = threading.local()


def _current() -> Optional[_Tape]:
    return getattr(_local, "tape", None)


@contextlib.contextmanager
def _use(tape: _Tape, replaying: bool):
    prev = _current()
    tape.replaying, tape.pos = replaying, 0
    _local.tape = tape
    try:
        yield
    finally:
        _local.tape = prev


def replaying() -> bool:
    """Whether a rematerialized block's replay is running in this thread."""
    tape = _current()
    return tape is not None and tape.replaying


def _detached(value):
    if isinstance(value, torch.Tensor):
        return value.detach()
    return tuple(_detached(v) for v in value)


def saved(compute: Callable, conv_output: bool = False):
    """`compute()`, a tensor or a tuple of tensors, kept for the replay of
    the rematerialized block that runs it: the forward computes and tapes
    it, the replay returns the taped value without computing. Outside such
    a block, and for a conv output under policy `PLANS`, it is `compute()`.
    Called inside an `autograd.Function`'s forward, the Function still
    saves what it saves, so the replay rebuilds the same node."""
    tape = _current()
    if tape is None or (conv_output and tape.policy != PLANS_AND_CONV_OUTPUTS):
        return compute()
    if tape.replaying:
        value = tape.values[tape.pos]
        tape.pos += 1
        return _detached(value)
    value = compute()
    tape.values.append(_detached(value))
    return value


def rematerializable(forward: Callable) -> Callable:
    """Decorator of a block's `forward`: while autograd records, a block
    whose `remat_policy` is set runs it under
    `torch.utils.checkpoint.checkpoint` with a tape of that policy;
    otherwise (inference, or the policy None, the default) it runs as it
    is. The blocks draw no random numbers, so the RNG state is not
    stashed."""

    @functools.wraps(forward)
    def run(self, *args):
        policy = getattr(self, "remat_policy", None)
        if policy is None or not torch.is_grad_enabled():
            return forward(self, *args)
        tape = _Tape(policy)
        return torch.utils.checkpoint.checkpoint(
            forward, self, *args, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=lambda: (_use(tape, False), _use(tape, True)))

    return run


def set_remat(model: nn.Module, block_types: Tuple[Type[nn.Module], ...],
              policy: str) -> None:
    """Rematerialize every submodule of `model` of one of `block_types`
    (each a block whose forward runs a `rematerializable` method) under
    `policy`. The parameters and `state_dict` keys do not change."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy must be one of {POLICIES}")
    for mod in model.modules():
        if isinstance(mod, block_types):
            mod.remat_policy = policy
