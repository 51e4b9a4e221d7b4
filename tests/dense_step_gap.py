"""Where the hybrid dense det step's gradients part from JAX's.

The setup of tests/test_torch_dense_train_step.py (grid (48, 48, 40), batch
2, the seed-0 weights shared through `utils/convert`). Prints the largest
gradient-leaf error, of each leaf's largest magnitude, between each pair
of six steps: the port's dense (`dense_from_level=2`) and sparse steps in
float32 and in float64, and JAX's jitted dense and sparse steps; the input
of the ReLU after the neck's deblock1 BatchNorm at CELL in each port run;
and the port's float64 dense step with that cell's mask set to 0 against
both JAX steps. With --two-pass-bn, flax's BatchNorm computes the variance
in two passes (`use_fast_variance=False`) in the JAX steps.

  JAX_PLATFORMS=cpu python tests/dense_step_gap.py [--two-pass-bn]

About 5 minutes on a CPU, most of it the two JAX jits.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CELL = (0, 223, 0, 1)    # (frame, channel, y, x) of deblock1's ReLU input


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--two-pass-bn", action="store_true")
    args = ap.parse_args(argv)

    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    if args.two_pass_bn:
        class BatchNorm(nn.BatchNorm):
            use_fast_variance: bool = False
        nn.BatchNorm = BatchNorm

    from link_tpu.data import det_pipeline as jdp
    from link_tpu.models.voxelnet import VoxelNet as JVoxelNet
    from link_tpu.train import det_trainer as JDT
    from link_tpu.train import schedules as JS
    from link_tpu.train.trainer import TrainState as JTrainState
    from link_tpu.utils.torch_import_det import translate_voxelnet
    from link_tpu_torch.data import det_pipeline as tdp
    from link_tpu_torch.models.center_head import center_head_loss
    from link_tpu_torch.models.voxelnet import VoxelNet as TVoxelNet
    from link_tpu_torch.train import det_trainer as TDT
    from link_tpu_torch.utils.convert import (from_jax_det_params,
                                              grads_state_dict)
    from test_torch_det_train_step import (CAPS, GRID, LR, ZERO_LEAF,
                                           _frames, _leaf_rel, _stash_grads)

    init = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                     dense_from_level=2, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    variables = translate_voxelnet({k: v.detach().numpy().copy()
                                    for k, v in init.state_dict().items()})
    shared = from_jax_det_params(variables["params"],
                                 variables["batch_stats"])
    jbatch = jdp.collate_det(_frames(jdp), voxel_capacity=CAPS[0],
                             max_objs=10, max_points=5)
    gbatch = {k: np.asarray(jbatch[k])[None]
              for k in ("voxels", "coords", "num_points", "nnz")}
    for key in tdp.TARGET_KEYS:
        gbatch[key] = [np.asarray(v)[None] for v in jbatch[key]]
    tbatch = tdp.collate_det(_frames(tdp), CAPS[0], max_points=5)

    def jax_grads(level):
        model = JVoxelNet(num_input_features=5, batch_size=2,
                          grid_shape=GRID, capacities=CAPS,
                          dense_from_level=level)
        real = JDT.make_one_cycle_adam
        JDT.make_one_cycle_adam = _stash_grads(real)
        try:
            init_fn, step = JDT.make_det_train_step(
                model, *JS.one_cycle(*LR), mesh=None)
        finally:
            JDT.make_one_cycle_adam = real
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = JTrainState(step=jnp.int32(0), params=params,
                            batch_stats=jax.tree_util.tree_map(
                                jnp.asarray, variables["batch_stats"]),
                            opt_state=init_fn(params))
        return step(state, gbatch)[0].opt_state[1]

    def port_grads(level, f64, mask_cell=False):
        """The port's gradients and the ReLU input at CELL. A float64 run
        casts the model and its inputs and sets each module's compute
        dtype; some ops still round to float32 (its dense and sparse
        steps agree to 2.5e-5)."""
        model = TVoxelNet(batch_size=2, grid_shape=GRID, capacities=CAPS,
                          dense_from_level=level, device="cpu")
        model.load_state_dict(shared, strict=True)
        dt = torch.float64 if f64 else torch.float32
        if f64:
            model.double()
            for mod in model.modules():
                if getattr(mod, "dtype", None) == torch.float32:
                    mod.dtype = torch.float64
        seen = {}

        def hook(mod, inp, out):
            x = inp[0]
            seen["x"] = float(x.detach()[CELL])
            if not mask_cell:
                return out
            mask = (x.detach() > 0).to(x.dtype)
            mask[CELL] = 0
            return x * mask

        h = model.neck.deblocks[1][2].register_forward_hook(hook)
        model.train()
        inputs = list(tdp.det_inputs(tbatch, "cpu"))
        inputs[0] = inputs[0].to(dt)
        example = {k: [t.to(dt) if t.is_floating_point() else t for t in v]
                   for k, v in tdp.det_targets(tbatch, "cpu").items()}
        loss, _ = center_head_loss(model(*inputs), example, 0.25,
                                   TDT.CODE_WEIGHTS)
        loss.backward()
        h.remove()
        return (translate_voxelnet(grads_state_dict(model))["params"],
                seen["x"])

    def worst(got_tree, want_tree):
        got = jax.tree_util.tree_leaves_with_path(got_tree)
        want = jax.tree_util.tree_leaves_with_path(want_tree)
        top = max(float(np.abs(np.asarray(w)).max()) for _, w in want)
        errs = {}
        for (path, g), (_, w) in zip(got, want):
            w = np.asarray(w, np.float64)
            floor = top if np.abs(w).max() < ZERO_LEAF * top else 0.0
            errs[jax.tree_util.keystr(path)] = _leaf_rel(g, w, floor=floor)
        key = max(errs, key=errs.get)
        return f"{errs[key]:.3e} ({key})"

    runs = {}
    for name, level, f64 in (("port dense f32", 2, False),
                             ("port sparse f32", None, False),
                             ("port dense f64", 2, True),
                             ("port sparse f64", None, True)):
        runs[name], x = port_grads(level, f64)
        print(f"{name}: deblock1's ReLU input at {CELL} {x:.4e}")
    runs["jax dense"] = jax_grads(2)
    runs["jax sparse"] = jax_grads(None)
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            print(f"{a} vs {b}: {worst(runs[a], runs[b])}")
    masked, _ = port_grads(2, True, mask_cell=True)
    for ref in ("jax dense", "jax sparse"):
        print(f"port dense f64 with the cell's mask at 0 vs {ref}: "
              f"{worst(masked, runs[ref])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
