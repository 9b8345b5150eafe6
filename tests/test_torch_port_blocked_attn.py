"""The port's fused blocked attention: its plain version against the
reference Pallas kernel run in interpret mode (both forward kernels), and
the wrapper's checks. The CUDA kernel itself runs only on the card and is
held against the plain version there by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from x2gnn_tpu.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu.data.graphs import build_mol_graph
from x2gnn_tpu.ops.pallas.blocked_attn import (
    expand_block_diagonal, pallas_blocked_attention)
from x2gnn_tpu_torch.data.synthetic import random_molecule
from x2gnn_tpu_torch.ops.blocked_attn import (
    blocked_attention, blocked_attention_bwd_plain, blocked_attention_plain)

H, C = 4, 8
HC = H * C
L, K = 7, 6
RADIAL_TOO_MANY = 400   # K whose W rows do not fit the backward's shared memory


def _problem(seed, di=None, dk=None):
    """Attention inputs on a real padded batch (as tests/test_pallas.py's
    _problem builds them), one molecule with an isolated (degree-0) atom.
    di/dk cut the query/key windows to rectangular ones."""
    rng = np.random.default_rng(seed)
    gs = []
    for i in range(3):
        numbers, pos = random_molecule(rng, int(rng.integers(5, 9)))
        if i == 0:   # an atom beyond the cutoff of every other
            numbers = np.append(numbers, 6).astype(np.int32)
            pos = np.vstack([pos, [40.0, 0.0, 0.0]])
        gs.append(build_mol_graph(numbers, pos, y=np.array([0.0]),
                                  edge_feat_dim=4))
    b = pad_graphs(gs, pad_budget_for(gs, 3), with_triplets=False)
    deg0 = b.node_mask & ~b.in_mask.any(1)
    assert deg0.any(), "test setup: expected a degree-0 atom"
    N, D = b.in_edges.shape
    di, dk = di or D, dk or D
    pos = b.positions
    in_src = b.edge_src[b.in_edges][:, :di]
    out_dst = b.edge_dst[b.out_edges][:, :dk]
    ji = pos[in_src] - pos[:, None, :]
    jk = pos[out_dst] - pos[:, None, :]
    cos_a = np.einsum("nid,nkd->nik", ji, jk)
    norm = np.maximum(np.linalg.norm(ji, axis=-1)[:, :, None]
                      * np.linalg.norm(jk, axis=-1)[:, None, :], 1e-12)
    f32 = np.float32
    return dict(
        q=rng.normal(size=(N, di, HC)).astype(f32),
        k=rng.normal(size=(N, dk, HC)).astype(f32),
        v=rng.normal(size=(N, dk, HC)).astype(f32),
        e_atom=rng.normal(size=(N, HC)).astype(f32),
        rbf=rng.normal(size=(N, dk, L * K)).astype(f32),
        w_sbf=(rng.normal(size=(L * K, HC)) * 0.3).astype(f32),
        bias=rng.normal(size=(HC,)).astype(f32),
        z=np.clip(cos_a / norm, -1.0, 1.0).astype(f32),
        a_ids=np.where(b.in_mask[:, :di], in_src, -1).astype(np.int32),
        b_ids=np.where(b.out_mask[:, :dk], out_dst, -2).astype(np.int32),
    )


def _reference(p, i_chunk=None):
    j = {name: jnp.asarray(a) for name, a in p.items()}
    return np.asarray(pallas_blocked_attention(
        j["q"], j["k"], j["v"], j["e_atom"], j["rbf"],
        expand_block_diagonal(j["w_sbf"], L, K, HC),
        j["bias"].reshape(1, HC), j["z"], j["a_ids"], j["b_ids"],
        heads=H, num_radial=K, interpret=True, i_chunk=i_chunk))


def _port(p, fn=blocked_attention_plain):
    t = {name: torch.from_numpy(a) for name, a in p.items()}
    return fn(t["q"], t["k"], t["v"], t["e_atom"], t["rbf"], t["w_sbf"],
              t["bias"], t["z"], t["a_ids"], t["b_ids"], heads=H,
              num_radial=K).numpy()


@pytest.mark.parametrize("window,i_chunk", [
    ("square", None), ("square", 2), ("rect", None), ("rect", 2)])
def test_plain_matches_pallas_interpret(window, i_chunk):
    """_fwd_kernel (i_chunk None) and _fwd_kernel_ichunk, at DI == DK and
    at DI != DK; the tolerance of tests/test_pallas.py."""
    p = _problem(0) if window == "square" else _problem(1, di=6, dk=4)
    ref = _reference(p, i_chunk)
    got = _port(p)
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-5)
    # fully masked rows (pad slots, degree-0 and pad atoms) are exactly 0
    dead = (p["a_ids"] < 0)
    assert dead.any()
    assert (got[dead] == 0).all()


def test_wrapper_on_cpu_runs_plain_version_and_launches_nothing():
    p = _problem(2)
    before = blocked_attention.launches
    np.testing.assert_array_equal(_port(p, blocked_attention), _port(p))
    assert blocked_attention.launches == before


def _tensors(p):
    return {name: torch.from_numpy(a) for name, a in p.items()}


FLOATS = ("q", "k", "v", "e_atom", "w_sbf", "bias")
ARGS = ("q", "k", "v", "e_atom", "rbf", "w_sbf", "bias", "z", "a_ids",
        "b_ids")


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference", "frozen"])
def test_autograd_function_on_cpu_gives_the_plain_gradients(mode):
    """The Function runs the plain versions on CPU tensors: with a gradient
    enabled its gradients are those of blocked_attention_bwd_plain; under
    no_grad, inference_mode, or with no input needing a gradient, it
    records no graph and its values are the plain forward's."""
    t = _tensors(_problem(4))
    if mode != "frozen":
        for name in FLOATS:
            t[name].requires_grad_(True)
    ctx = {"no_grad": torch.no_grad,
           "inference": torch.inference_mode}.get(mode, torch.enable_grad)
    with ctx():
        out = blocked_attention(*(t[n] for n in ARGS), heads=H, num_radial=K)
    assert out.requires_grad == (mode == "grad")
    with torch.no_grad():
        plain = blocked_attention_plain(*(t[n] for n in ARGS), heads=H,
                                        num_radial=K)
    np.testing.assert_array_equal(out.detach().numpy(), plain.numpy())
    if mode != "grad":
        return
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, [t[n] for n in FLOATS], g)
    want = blocked_attention_bwd_plain(
        *(t[n].detach() for n in ARGS), g, heads=H, num_radial=K, out=plain)
    for name, a, b in zip(FLOATS, got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("shape", ValueError), ("contig", ValueError),
    ("heads", ValueError), ("degree", ValueError), ("head_dim", ValueError),
    ("device", ValueError), ("orders", ValueError), ("radial", ValueError)])
def test_wrapper_rejects(case, exc):
    t = _tensors(_problem(3))
    heads = H
    if case == "dtype":
        t["z"] = t["z"].double()
    elif case == "shape":
        t["bias"] = t["bias"][:-1]
    elif case == "contig":
        t["q"] = t["q"].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "heads":
        heads = 5
    elif case == "degree":
        for name in ("k", "v", "rbf"):
            t[name] = t[name].repeat(1, 17, 1)
        t["z"] = t["z"].repeat(1, 1, 17)
        t["b_ids"] = t["b_ids"].repeat(1, 17)
    elif case == "head_dim":
        heads = 2          # HC = 48 gives C = 24, which does not divide 32
        for name in ("q", "k", "v", "e_atom", "w_sbf", "bias"):
            t[name] = torch.cat([t[name], t[name][..., :16]], dim=-1)
    elif case == "device":
        t["z"] = t["z"].to("meta")
    elif case == "orders":     # L = 9 spherical orders, beyond MAX_L = 8
        t["rbf"] = torch.cat([t["rbf"], t["rbf"][..., :2 * K]], dim=-1)
        t["w_sbf"] = torch.cat([t["w_sbf"], t["w_sbf"][:2 * K]], dim=0)
    elif case == "radial":
        t["rbf"] = t["rbf"][..., :1].repeat(1, 1, L * RADIAL_TOO_MANY)
        t["w_sbf"] = t["w_sbf"][:1].repeat(L * RADIAL_TOO_MANY, 1)
    with pytest.raises(exc):
        blocked_attention(t["q"], t["k"], t["v"], t["e_atom"], t["rbf"],
                          t["w_sbf"], t["bias"], t["z"], t["a_ids"],
                          t["b_ids"], heads=heads,
                          num_radial=RADIAL_TOO_MANY if case == "radial"
                          else K)

