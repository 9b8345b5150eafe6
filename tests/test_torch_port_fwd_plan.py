"""The forward kernel's launch plan (`fwd_plan` in
x2gnn_tpu_torch/ops/blocked_attn.py), which `_check` consults and the CUDA
entry point checks again: it runs on the card only, but the plan is plain
Python and is held here to what the kernel needs at every window it
takes."""

import dataclasses

import pytest
import torch

from x2gnn_tpu_torch.ops.blocked_attn import (
    MAX_SMEM_PER_CTA, SMEM_PER_SM, SMEM_RESERVED_PER_CTA, _check, bwd_plan,
    fwd_plan)

HC, HEADS, K = 128, 16, 6          # the flagship's channels and radial basis
DEGREES = (1, 8, 24, 32, 48, 64)


def _assert_fits_one_sm(plan):
    assert 0 < plan.smem_bytes <= MAX_SMEM_PER_CTA
    assert plan.ctas_per_sm * (plan.smem_bytes + SMEM_RESERVED_PER_CTA) \
        <= SMEM_PER_SM
    assert plan.threads * plan.warpgroups <= 512


def _assert_covers_every_atom_once(plan, N):
    """CTA r walks the atoms r, r + grid, ... (the kernel's loop): every
    atom exactly once, every CTA at least one."""
    walked = [range(r, N, plan.grid) for r in range(plan.grid)]
    assert sorted(n for atoms in walked for n in atoms) == list(range(N))
    assert min(len(a) for a in walked) >= 1


@pytest.mark.parametrize("L", [1, 7, 8])
@pytest.mark.parametrize("DK", DEGREES)
@pytest.mark.parametrize("DI", DEGREES)
def test_plan_fits_the_card_and_covers_every_atom_once(DI, DK, L):
    for N in (1, 37, 328, 760, 1024):
        plan = fwd_plan(N, DI, DK, HC, HEADS, L, K)
        _assert_fits_one_sm(plan)
        assert plan.ctas_per_sm == 4 // plan.warpgroups
        assert plan.threads * plan.channel_groups == HC
        assert 1 <= plan.i_chunk <= DI
        assert plan.grid == min(N, 132 * plan.ctas_per_sm)
        _assert_covers_every_atom_once(plan, N)


@pytest.mark.parametrize("DI,DK", [(24, 24), (32, 32), (48, 48), (24, 32)])
def test_plan_depends_on_the_shape_only(DI, DK):
    """The same shape gives the same plan, and the grid grows with N up to
    a constant (132 SMs' worth of CTAs), not with the card."""
    plans = [fwd_plan(N, DI, DK, HC, HEADS, 7, K) for N in (760, 760, 5000)]
    assert plans[0] == plans[1] == plans[2]
    small = fwd_plan(40, DI, DK, HC, HEADS, 7, K)
    assert small == dataclasses.replace(plans[0], grid=40)


@pytest.mark.parametrize("N,D", [(1024, 24), (760, 32), (512, 48), (328, 48)])
def test_plan_keeps_sixteen_warps_per_sm_at_the_main_path_shapes(N, D):
    """Serving (N=1024, D=24; the AID-scale N=512, D=48) and training
    (N=760, D=32; the AID-scale step's N=328, D=48): 16 resident warps per
    SM, the query axis chunked at D=48 instead of dropping warpgroups."""
    plan = fwd_plan(N, D, D, HC, HEADS, 7, K)
    assert plan.ctas_per_sm * plan.warpgroups * plan.threads // 32 == 16
    assert plan.i_chunk >= min(D, 24)


@pytest.mark.parametrize("hc,heads", [(256, 32), (512, 64), (1024, 128),
                                      (1024, 32), (96, 12), (64, 2)])
def test_shared_memory_does_not_grow_with_the_channels(hc, heads):
    """Channels go in groups of at most 128 along grid.y, heads never
    straddle a group, and a group's shared memory is that of the same
    group at HC = its width."""
    plan = fwd_plan(760, 32, 32, hc, heads, 7, K)
    C = hc // heads
    assert plan.threads * plan.channel_groups == hc
    assert plan.threads % C == 0 and plan.threads <= 128
    assert plan == dataclasses.replace(
        fwd_plan(760, 32, 32, plan.threads, plan.threads // C, 7, K),
        channel_groups=plan.channel_groups)
    _assert_fits_one_sm(plan)


@pytest.mark.parametrize("DK", [1, 32, 64])
@pytest.mark.parametrize("L,K_", [(7, 7), (7, 9), (8, 12), (4, 24)])
def test_plan_takes_every_radial_basis_the_backward_takes(L, K_, DK):
    """A shape `_check` accepts launches both kernels: where the backward
    has a plan (K > 6 keeps its dW in shared memory), so does the
    forward."""
    for N in (1, 760):
        bwd_plan(N, 32, DK, HC, HEADS, L, K_)
        plan = fwd_plan(N, 32, DK, HC, HEADS, L, K_)
        _assert_fits_one_sm(plan)
        _assert_covers_every_atom_once(plan, N)


def _first_kernel_smem_bytes(DI, DK, hc, heads, L, K_):
    """Shared memory of the first forward kernel (one CTA of HC threads per
    atom): k + e, v + e, q and the accumulator rows of the whole atom, G
    for a tile of 8 keys, the tile's Legendre values, per-(query, head)
    max and denominator, the atom's rbf rows, the prefactors and the
    ids."""
    words = (2 * DK * hc + 2 * DI * hc + 8 * L * hc + DI * 8 * L
             + 2 * DI * heads + DK * L * K_ + L + DI + DK)
    return 4 * words


@pytest.mark.parametrize("hc,heads,D,first_bytes", [
    (1024, 128, 20, 585_564),    # G alone took 229,376 B at HC=1024, L=7
    (512, 64, 32, 406_044),      # HC=512 was refused from D=13 on
])
def test_widths_check_accepts_now_fit_the_forward(hc, heads, D, first_bytes):
    """The fault this plan repairs: `_check` accepted these shapes (it
    asked only the backward's plan), and the first forward kernel's shared
    memory, which grew with HC, went beyond the 232,448 B a CTA may have,
    so the launch was refused ("invalid argument"). Now `_check` asks both
    plans and the forward's shared memory no longer grows with HC."""
    L = 7
    assert _first_kernel_smem_bytes(D, D, hc, heads, L, K) == first_bytes
    assert first_bytes > MAX_SMEM_PER_CTA
    N = 2
    f32 = dict(dtype=torch.float32)
    ids = torch.zeros((N, D), dtype=torch.int32)
    _check(torch.zeros((N, D, hc), **f32), torch.zeros((N, D, hc), **f32),
           torch.zeros((N, D, hc), **f32), torch.zeros((N, hc), **f32),
           torch.zeros((N, D, L * K), **f32), torch.zeros((L * K, hc), **f32),
           torch.zeros(hc, **f32), torch.zeros((N, D, D), **f32), ids, ids,
           heads, K)
    plan = fwd_plan(760, D, D, hc, heads, L, K)
    assert plan.smem_bytes <= MAX_SMEM_PER_CTA
    assert plan.channel_groups == hc // 128
    _assert_fits_one_sm(plan)


@pytest.mark.parametrize("args", [
    (0, 8, 8, HC, HEADS, 7, K),       # no atom
    (10, 0, 8, HC, HEADS, 7, K),      # empty query window
    (10, 65, 8, HC, HEADS, 7, K),     # beyond 64 query slots
    (10, 8, 65, HC, HEADS, 7, K),     # beyond 64 key slots
    (10, 8, 8, HC, HEADS, 9, K),      # L = 9
    (10, 8, 8, HC, HEADS, 0, K),      # L = 0
    (10, 8, 8, HC, HEADS, 7, 0),      # K = 0
    (10, 8, 64, HC, HEADS, 7, 64),    # W and rbf rows beyond shared memory
    (10, 8, 8, 48, 2, 7, K),          # C = 24 does not divide 32
    (10, 8, 8, 1056, 132, 7, K),      # HC beyond 1024
    (10, 8, 8, 40, 5, 7, K),          # HC not a multiple of 32
    (10, 8, 8, HC, 0, 7, K),          # no heads
])
def test_plan_raises_on_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        fwd_plan(*args)
