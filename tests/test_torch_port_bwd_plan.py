"""The backward kernel's launch plan (`bwd_plan` in
x2gnn_tpu_torch/ops/blocked_attn.py), which the CUDA entry point checks
again: it runs on the card only, but the plan is plain Python and is held
here to what the kernel needs at every window it takes."""

import dataclasses

import pytest

from x2gnn_tpu_torch.ops.blocked_attn import (
    MAX_SMEM_PER_CTA, SMEM_PER_SM, SMEM_RESERVED_PER_CTA, bwd_plan)

HC, HEADS, K = 128, 16, 6          # the flagship's channels and radial basis
DEGREES = (1, 8, 24, 32, 48, 64)


@pytest.mark.parametrize("L", [1, 7, 8])
@pytest.mark.parametrize("DK", DEGREES)
@pytest.mark.parametrize("DI", DEGREES)
def test_plan_fits_the_card_and_covers_every_atom_once(DI, DK, L):
    for N in (1, 37, 328, 760, 1024):
        plan = bwd_plan(N, DI, DK, HC, HEADS, L, K)
        # shared memory: one CTA, and the CTAs the plan puts on an SM
        assert 0 < plan.smem_bytes <= MAX_SMEM_PER_CTA
        assert plan.ctas_per_sm == 4 // plan.warpgroups
        assert plan.ctas_per_sm * (plan.smem_bytes + SMEM_RESERVED_PER_CTA) \
            <= SMEM_PER_SM
        assert plan.threads * plan.warpgroups <= 512
        assert plan.threads * plan.channel_groups == HC
        assert 1 <= plan.i_chunk <= DI
        _assert_covers_every_atom_once(plan, N)


def _assert_covers_every_atom_once(plan, N):
    """CTA r walks the atoms r, r + grid, ... (the kernel's loop): every
    atom exactly once, every CTA at least one."""
    walked = [range(r, N, plan.grid) for r in range(plan.grid)]
    assert sorted(n for atoms in walked for n in atoms) == list(range(N))
    assert min(len(a) for a in walked) >= 1


@pytest.mark.parametrize("DK", [1, 32, 64])
@pytest.mark.parametrize("L,K", [(7, 7), (7, 8), (7, 9), (8, 9), (8, 12),
                                 (4, 24)])
def test_plan_takes_more_radial_functions_than_registers_hold(L, K, DK):
    """K > 6 keeps dW in shared memory, L*K rows per warpgroup; the plan
    still fits one SM and covers every atom once, with fewer warpgroups
    where four do not fit."""
    for N in (1, 760):
        plan = bwd_plan(N, 32, DK, HC, HEADS, L, K)
        assert 0 < plan.smem_bytes <= MAX_SMEM_PER_CTA
        assert plan.ctas_per_sm * (plan.smem_bytes + SMEM_RESERVED_PER_CTA) \
            <= SMEM_PER_SM
        assert 1 <= plan.warpgroups <= min(4, DK)
        assert plan.grid == min(N, 132 * plan.ctas_per_sm)
        _assert_covers_every_atom_once(plan, N)
    if DK >= 4 and L * K <= 63:
        assert plan.warpgroups == 4


@pytest.mark.parametrize("DI,DK", [(24, 24), (32, 32), (48, 48), (24, 32)])
def test_plan_depends_on_the_shape_only(DI, DK):
    """The grid, and with it the order of dW/db's sums, is a function of
    the shape: the same shape gives the same plan, and the grid grows with
    N up to a constant (132 SMs' worth of CTAs), not with the card."""
    plans = [bwd_plan(N, DI, DK, HC, HEADS, 7, K) for N in (760, 760, 5000)]
    assert plans[0] == plans[1] == plans[2]
    small = bwd_plan(40, DI, DK, HC, HEADS, 7, K)
    assert small == dataclasses.replace(plans[0], grid=40)


def test_plan_keeps_sixteen_warps_per_sm_at_the_training_shapes():
    """Four warpgroups of 128 threads (16 warps, one CTA per SM) at
    N=760, D=32 and at the D>40 window N=328, D=48: the query axis is
    chunked instead of dropping warpgroups."""
    for N, D in ((760, 32), (328, 48)):
        plan = bwd_plan(N, D, D, HC, HEADS, 7, K)
        assert (plan.warpgroups, plan.threads) == (4, 128)
        assert plan.i_chunk >= 16


@pytest.mark.parametrize("args", [
    (0, 8, 8, HC, HEADS, 7, K),       # no atom
    (10, 0, 8, HC, HEADS, 7, K),      # empty query window
    (10, 65, 8, HC, HEADS, 7, K),     # beyond 64 query slots
    (10, 8, 65, HC, HEADS, 7, K),     # beyond 64 key slots
    (10, 8, 8, HC, HEADS, 9, K),      # L = 9
    (10, 8, 64, HC, HEADS, 7, 64),    # W, rbf and dW rows beyond smem
    (10, 8, 8, HC, HEADS, 0, K),      # L = 0
    (10, 8, 8, 48, 2, 7, K),          # C = 24 does not divide 32
    (10, 8, 8, 1056, 132, 7, K),      # HC beyond 1024
    (10, 8, 8, 40, 5, 7, K),          # HC not a multiple of 32
    (10, 8, 8, HC, 0, 7, K),          # no heads
])
def test_plan_raises_on_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        bwd_plan(*args)
