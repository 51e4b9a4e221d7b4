"""Where two runs of one train step part ways: the first module whose
forward output differs, the ReLU inputs that change sign, and the
gradients' gaps, within one process and across processes.

    python3 -m link_tpu_torch.tools.grad_gap [--device cuda:0] \
        [--out chiprun_out/grad_gap.json]

The step is `dp_check`'s one-device seg step (ELKUNet cr1.0 f32, replica
0's scan, the seed-0 weights, TF32 off). It runs RUNS times in this
process, then RUNS times in each of three fresh processes (the `spawn`
start method), two with PYTHONHASHSEED=1 and one with PYTHONHASHSEED=2, so
that a gap that only processes show, and one that follows the hash seed,
can be told from the run-to-run spread of one process. For each pair of
runs it prints: the number of modules whose output differs and the first
of them in forward order, the ReLU inputs that change sign (the count,
the first ReLU and its largest such |x|), and the gradients'
`dp_check.grad_gaps`, worst entry, and the entry gap at LEAF (of that
leaf's largest), the leaf whose worst entry the data-parallel holds saw
move most.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
from typing import Dict

import torch
from torch import nn

from ..nn.modules import SparseReLU
from . import dp_check

RUNS = 3
LEAF = "stage3.1.net.3.kernel"


def _feats(x):
    return x.feats if hasattr(x, "feats") else x


def run_step(job: Dict, device) -> Dict:
    """One step of `job` on replica 0's batch with every leaf module
    hooked: each output's sha1 in call order, and each ReLU's input (its
    signs and values, on the host). Returns them with the gradients."""
    model, opt = dp_check.build(job, device)
    names = {m: n for n, m in model.named_modules()}
    rec = {"order": [], "digest": {}, "relu": {}}

    def hook(m, inp, out):
        t = _feats(out)
        if not torch.is_tensor(t):
            return
        key = names[m]
        while key in rec["digest"]:          # a module called again
            key += "'"
        rec["order"].append(key)
        rec["digest"][key] = hashlib.sha1(
            t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
            .numpy()).hexdigest()
        if isinstance(m, (SparseReLU, nn.ReLU)):
            rec["relu"][key] = _feats(inp[0]).detach().float().cpu()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if not list(m.children())]
    dp_check.step_fn(job)(model, opt, job["batches"][0])
    for h in handles:
        h.remove()
    rec["grads"] = {k: p.grad.detach().cpu()
                    for k, p in model.named_parameters()}
    return rec


def _child(_, index: int, job_path: str, device: str, runs: int,
           out_dir: str) -> None:
    """A fresh process's runs (`torch.multiprocessing.spawn` passes its
    process index first; `index` names the files)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_path, weights_only=False)
    for r in range(runs):
        torch.save(run_step(job, torch.device(device)),
                   os.path.join(out_dir, f"child{index}_{r}.pt"))


def compare_runs(a: Dict, b: Dict, leaf: str) -> Dict:
    """What differs between two recorded runs."""
    differ = [k for k in a["order"] if a["digest"][k] != b["digest"].get(k)]
    flips, first = {}, None
    for k in a["order"]:
        if k not in a["relu"]:
            continue
        x, y = a["relu"][k], b["relu"][k]
        flip = (x > 0) != (y > 0)
        if flip.any():
            mag = float(torch.maximum(x.abs(), y.abs())[flip].max())
            flips[k] = [int(flip.sum()), mag]
            first = first or k
    gaps = dp_check.grad_gaps(b["grads"], a["grads"])
    out = {"modules_differing": len(differ),
           "first_differing": differ[0] if differ else None,
           "relu_flips": sum(v[0] for v in flips.values()),
           "first_flip": [first, flips[first]] if first else None,
           "grad_norm": gaps["norm"], "grad_dist": gaps["dist"],
           "grad_entry_worst": dp_check._entry_worst(b["grads"],
                                                     a["grads"])}
    if leaf in a["grads"]:
        w = a["grads"][leaf].double()
        out["leaf_entry_gap"] = float((b["grads"][leaf].double() - w)
                                      .abs().max() / w.abs().max())
        out["flips_by_relu"] = flips
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device}: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = dp_check.seg_job(1)
    device = torch.device(args.device)
    runs = {f"parent{r}": run_step(job, device) for r in range(RUNS)}
    with tempfile.TemporaryDirectory() as tmp:
        job_path = os.path.join(tmp, "job.pt")
        torch.save(job, job_path)
        seeds = ("1", "1", "2")
        saved = os.environ.get("PYTHONHASHSEED")
        try:
            for i, seed in enumerate(seeds):
                os.environ["PYTHONHASHSEED"] = seed
                torch.multiprocessing.spawn(
                    _child, args=(i, job_path, args.device, RUNS, tmp),
                    nprocs=1)
                for r in range(RUNS):
                    runs[f"child{i}_{r}"] = torch.load(
                        os.path.join(tmp, f"child{i}_{r}.pt"),
                        weights_only=False)
        finally:
            if saved is None:
                os.environ.pop("PYTHONHASHSEED", None)
            else:
                os.environ["PYTHONHASHSEED"] = saved
    pairs = [("parent0", f"parent{r}") for r in range(1, RUNS)]
    pairs += [("child0_0", "child0_1"), ("child0_0", "child1_0"),
              ("child0_0", "child2_0"), ("parent0", "child0_0")]
    out = {"leaf": LEAF,
           "hash_seeds": {"parent": os.environ.get("PYTHONHASHSEED"),
                          "child0": "1", "child1": "1", "child2": "2"},
           "pairs": {f"{a} vs {b}": compare_runs(runs[a], runs[b], LEAF)
                     for a, b in pairs}}
    for name, r in out["pairs"].items():
        brief = {k: v for k, v in r.items() if k != "flips_by_relu"}
        print(f"{name}: {json.dumps(brief)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
