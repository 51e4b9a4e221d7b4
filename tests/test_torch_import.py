"""Checkpoint translation structure test: a synthetic torch-style
state_dict with the reference's module names must map exactly onto the
flax ELKUNet variable tree (same paths, same shapes)."""

import numpy as np
import jax
import pytest

from link_tpu.models.linkunet import ELKUNet
from link_tpu.sparse.tensor import make_sparse_tensor
from link_tpu.utils.torch_import import translate_elkunet

import oracles
from test_sparse_core import pad_coords, pad_feats
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = (256, 128, 64, 32, 16)


def make_reference_state_dict(cr=0.125, num_classes=20, groups=1):
    """Emulate the reference ELKUNet state_dict key set (linkunet.py
    module tree) with random arrays in the reference layouts."""
    cs = [int(cr * 64)] * 9
    rng = np.random.default_rng(0)
    sd = {}

    def conv(name, ci, co, k=27):
        sd[name + ".kernel"] = rng.standard_normal((k, ci, co)).astype(
            np.float32) if k > 1 else rng.standard_normal((ci, co)).astype(
                np.float32)

    def bnorm(name, c):
        sd[name + ".weight"] = np.ones(c, np.float32)
        sd[name + ".bias"] = np.zeros(c, np.float32)
        sd[name + ".running_mean"] = np.zeros(c, np.float32)
        sd[name + ".running_var"] = np.ones(c, np.float32)

    def lin(name, ci, co, bias=True):
        sd[name + ".weight"] = rng.standard_normal((co, ci)).astype(np.float32)
        if bias:
            sd[name + ".bias"] = np.zeros(co, np.float32)

    def ln(name, c):
        sd[name + ".weight"] = np.ones(c, np.float32)
        sd[name + ".bias"] = np.zeros(c, np.float32)

    conv("stem.0", 4, cs[0])
    bnorm("stem.1", cs[0])
    conv("stem.3", cs[0], cs[0])
    bnorm("stem.4", cs[0])

    def res(name, ci, co):
        conv(name + ".net.0", ci, co)
        bnorm(name + ".net.1", co)
        conv(name + ".net.3", co, co)
        bnorm(name + ".net.4", co)
        if ci != co:
            conv(name + ".downsample.0", ci, co, k=1)
            bnorm(name + ".downsample.1", co)

    for lvl in range(1, 5):
        ci = cs[lvl - 1]
        co = cs[lvl]
        conv(f"down{lvl}.0.net.0", ci, ci, k=8)
        bnorm(f"down{lvl}.0.net.1", ci)
        res(f"stage{lvl}.0", ci, co)
        res(f"stage{lvl}.1", co, co)
        conv(f"stage{lvl}_tail.0", co, co)
        bnorm(f"stage{lvl}_tail.1", co)
        lin(f"elk{lvl}.pre_mix.0", ci, ci, bias=False)
        ln(f"elk{lvl}.pre_mix.1", ci)
        conv(f"elk{lvl}.local_mix.0", ci, ci)
        lin(f"elk{lvl}.pos_weight.0", 3, ci // groups, bias=False)
        sd[f"elk{lvl}.alpha"] = np.ones((1, ci // groups), np.float32)
        ln(f"elk{lvl}.norm", ci)
        ln(f"elk{lvl}.norm_local", ci)
        conv(f"elk{lvl}_tail.0", ci, co)
        bnorm(f"elk{lvl}_tail.1", co)

    for lvl, (ci, co, skip) in enumerate(
            [(cs[4], cs[5], cs[3]), (cs[5], cs[6], cs[2]),
             (cs[6], cs[7], cs[1]), (cs[7], cs[8], cs[0])], start=1):
        conv(f"up{lvl}.0.net.0", ci, co, k=8)
        bnorm(f"up{lvl}.0.net.1", co)
        res(f"up{lvl}.1.0", co + skip, co)
        res(f"up{lvl}.1.1", co, co)

    lin("classifier.0", cs[8], num_classes)
    return sd


def tree_paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.shape(v)
    return out


@pytest.mark.slow          # ~90 s: full ELKUNet init just for tree shapes
def test_translation_matches_flax_tree():
    sd = make_reference_state_dict()
    translated = translate_elkunet(sd)

    rng = np.random.default_rng(1)
    coords, feats = oracles.random_cloud(rng, 200, span=(40, 40, 16),
                                         channels=4)
    st = make_sparse_tensor(pad_feats(feats, CAPS[0]),
                            pad_coords(coords, CAPS[0]), nnz=len(coords))
    model = ELKUNet(num_classes=20, cr=0.125, capacities=CAPS)
    variables = model.init(jax.random.PRNGKey(0), st, False)

    want_p = tree_paths(jax.tree_util.tree_map(np.asarray,
                                               variables["params"]))
    got_p = tree_paths(translated["params"])
    assert set(got_p) == set(want_p), (
        f"missing={sorted(set(want_p)-set(got_p))[:6]} "
        f"extra={sorted(set(got_p)-set(want_p))[:6]}")
    for k in want_p:
        assert got_p[k] == want_p[k], (k, got_p[k], want_p[k])

    want_s = tree_paths(jax.tree_util.tree_map(np.asarray,
                                               variables["batch_stats"]))
    got_s = tree_paths(translated["batch_stats"])
    assert set(got_s) == set(want_s), (
        f"missing={sorted(set(want_s)-set(got_s))[:6]} "
        f"extra={sorted(set(got_s)-set(want_s))[:6]}")

    # translated params must actually run
    out = model.apply({"params": translated["params"],
                       "batch_stats": translated["batch_stats"]}, st, False)
    assert np.isfinite(np.asarray(out)[:len(coords)]).all()
