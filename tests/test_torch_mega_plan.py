"""The megakernel's launch plan (``ops/kernels/megakernel.py`` ``plan``).

The plan is a pure function of the shape, the cone tables and the card's
SM count and shared memory, so its guarantees are checked here on the
CPU: every row of A in exactly one CTA, no SOC/RSOC block or exp/pow
3-block split between two CTAs, at most one CTA per SM, shared memory
within the card's budget. The partition's sums, emulated in f64 in the
kernel's order (per-CTA partials summed in CTA order), equal the plain
matvecs. The kernel itself runs only on the card (``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
import totsu_tpu_torch as tt
from totsu_tpu_torch.ops.kernels import dual_matvec as dm
from totsu_tpu_torch.ops.kernels import megakernel as mk

#: an H100's opt-in shared memory per block (bytes)
SMEM = 232_448


@functools.lru_cache(maxsize=None)
def _shape(name):
    """(m, n, cone) of the smoke's megakernel shapes and a mixed cone."""
    if name == "lp100":
        return 400, 100, tt.ConeLayout([tt.rpos(400)])
    if name == "qp50":
        return 102, 51, tt.ConeLayout([tt.rsoc(52), tt.rpos(50)])
    if name == "gp":
        prob, _ = tt.problems.gp(*cs.make_gp_terms(), device="cpu",
                                 dtype=torch.float32)
        return prob.shape[0], prob.shape[1], prob.cone
    if name == "growth":
        *_, a, _, spec, _ = cs.make_growth(64, 50, -2.0)
        return a.shape[0], a.shape[1], cs.cone(tt, spec)
    if name == "lp1000":
        return 4000, 1000, tt.ConeLayout([tt.rpos(4000)])
    cone = tt.ConeLayout([tt.zero(3), tt.soc(5, count=7), tt.rsoc(4, 3),
                          tt.rsoc(1, 2), tt.expc(10), tt.powc(0.3, 5),
                          tt.rpos(20)])
    return cone.dim, 30, cone


SHAPES = ["lp100", "qp50", "gp", "growth", "lp1000", "mixed"]
SMS = [1, 7, 132]


def _plan(name, sm, **kw):
    m, n, cone = _shape(name)
    return mk.plan(m, n, mk.cone_tables(cone), sm, SMEM, **kw), cone


def _owner(pl, row):
    return int(np.searchsorted(pl.row_off, row, side="right")) - 1


@pytest.mark.parametrize("sm", SMS)
@pytest.mark.parametrize("name", SHAPES)
def test_plan_covers_every_row_once_and_keeps_blocks_whole(name, sm):
    pl, cone = _plan(name, sm)
    _, blocks, tri, _ = mk.cone_tables(cone)
    assert 1 <= pl.grid <= sm
    assert pl.row_off[0] == 0 and pl.row_off[-1] == pl.m
    assert all(a < b for a, b in zip(pl.row_off, pl.row_off[1:]))
    assert len(pl.row_off) == len(pl.blk_off) == len(pl.tri_off) \
        == pl.grid + 1 and len(pl.a_smem) == pl.grid
    for table, dims, off in ((blocks, blocks[:, 1], pl.blk_off),
                             (tri, np.full(len(tri), 3), pl.tri_off)):
        for bi, (start, dim) in enumerate(zip(table[:, 0], dims)):
            g = _owner(pl, start)
            assert _owner(pl, start + dim - 1) == g  # never straddles
            assert off[g] <= bi < off[g + 1]          # in its CTA's slice


@pytest.mark.parametrize("sm", SMS)
@pytest.mark.parametrize("name", SHAPES)
def test_plan_keeps_shared_memory_within_budget(name, sm):
    pl, _ = _plan(name, sm)
    sizes = np.diff(pl.row_off)
    assert pl.rows_max == sizes.max()
    assert pl.ws_floats == mk.workspace_floats(pl.n, pl.rows_max)
    assert pl.a_floats == max([r * pl.n for r, s in zip(sizes, pl.a_smem)
                               if s], default=0)
    assert pl.smem_bytes == 4 * ((pl.ws_floats if pl.vec_smem else 0)
                                 + pl.a_floats)
    assert pl.smem_bytes + mk.STATIC_SMEM <= SMEM
    if pl.vec_smem:
        assert 4 * pl.ws_floats <= mk.VEC_SMEM_BYTES
    # the pass's layout: whole warps, row sets only when n fits one set
    sets = pl.threads // pl.col_threads
    assert pl.threads == mk.THREADS and pl.col_threads % 32 == 0
    assert sets * pl.col_threads == pl.threads
    assert sets == 1 or pl.n <= pl.col_threads * mk.STEPS
    assert pl.ld >= pl.n + mk.SCALARS and pl.ld % 4 == 0
    assert pl.partials_len == ((2 * pl.grid + 1) * pl.ld if pl.grid > 1
                               else 0)
    assert not pl.split or pl.grid > 1


@pytest.mark.parametrize("name", SHAPES)
def test_local_tables_are_relative_to_their_cta(name):
    pl, cone = _plan(name, 132)
    tables = mk.cone_tables(cone)
    kind, blocks, tri, alpha = mk.local_tables(pl, tables)
    assert kind is tables[0] and alpha is tables[3]
    for table, dims, off in ((blocks, blocks[:, 1], pl.blk_off),
                             (tri, np.full(len(tri), 3), pl.tri_off)):
        for g in range(pl.grid):
            rows = len(pl.rows(g))
            for start, dim in zip(table[off[g]:off[g + 1], 0],
                                  dims[off[g]:off[g + 1]]):
                assert 0 <= start and start + dim <= rows
    # the cached tables are left as they were
    assert tables[1].flags.writeable is False


def test_plan_main_path_shapes_on_an_h100():
    # the n=50 QP stays on one CTA and the n=100 LP on a few; the GP and
    # the n=1000 LP spread over many SMs with split sums; every slice of A
    # in shared memory
    pl, _ = _plan("qp50", 132)
    assert pl.grid == 1 and all(pl.a_smem)
    assert "G=1," in pl.describe()
    pl, _ = _plan("lp100", 132)
    assert 1 < pl.grid <= 8 and all(pl.a_smem) and not pl.split
    for name in ("gp", "lp1000"):
        pl, _ = _plan(name, 132)
        assert pl.grid > 32 and all(pl.a_smem) and pl.split
        assert pl.a_smem_bytes == 4 * pl.m * pl.n


def test_plan_model_prefers_fewer_batches_and_cheap_sums():
    # the model's terms: a grid sum costs more than the pass it shortens
    # on the QP; the replicated sums' rounds of loads grow with G, the
    # split mode's do not
    m, n, cone = _shape("lp1000")
    tables = mk.cone_tables(cone)
    rep = [mk.plan(m, n, tables, 132, SMEM, grid=g, split=False).update_us
           for g in (90, 132)]
    spl = [mk.plan(m, n, tables, 132, SMEM, grid=g, split=True).update_us
           for g in (90, 132)]
    assert rep[1] > rep[0] and spl[1] <= spl[0] < rep[0]
    assert mk._sum_rounds(1004, 132) == 2 * 17
    assert mk._sum_rounds(8, 132) == 1
    m, n, cone = _shape("qp50")
    tables = mk.cone_tables(cone)
    assert mk.plan(m, n, tables, 132, SMEM, grid=2).update_us \
        > mk.plan(m, n, tables, 132, SMEM, grid=1).update_us


def test_plan_is_pure_and_refuses_bad_input():
    m, n, cone = _shape("gp")
    tables = mk.cone_tables(cone)
    assert mk.plan(m, n, tables, 132, SMEM) == mk.plan(m, n, tables, 132,
                                                       SMEM)
    with pytest.raises(ValueError, match="plan"):
        mk.plan(0, n, tables, 132, SMEM)
    with pytest.raises(ValueError, match="plan"):
        mk.plan(m, n, mk.cone_tables(tt.ConeLayout([tt.rpos(5)])), 132,
                SMEM)
    with pytest.raises(ValueError, match="plan"):
        mk.plan(m, n, tables, 132, SMEM, grid=133)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("grid", [1, 2, 5, 13])
def test_plan_overrides(grid, split):
    pl, _ = _plan("lp100", 132, grid=grid, split=split)
    assert pl.grid == grid and pl.split == (split and grid > 1)
    assert pl.vec_smem
    pl, _ = _plan("lp100", 132, grid=grid, split=split, vec_smem=False)
    assert not pl.vec_smem and pl.smem_bytes == 4 * pl.a_floats


def _emulate(a, x, y, pl):
    """The kernel's matvec pair in the plan's partition: each CTA's p
    (its rows, complete) and its partial of q with its m-side sum b.y,
    then the partials summed over the CTAs in index order (the same order
    in the replicated and the split mode)."""
    p = torch.empty(pl.m, dtype=a.dtype)
    rows = torch.zeros(pl.grid, pl.n + 1, dtype=a.dtype)
    for g in range(pl.grid):
        r = slice(pl.row_off[g], pl.row_off[g + 1])
        p[r] = a[r] @ x
        rows[g, :pl.n] = y[r] @ a[r]
        rows[g, pl.n] = y[r].sum()
    total = rows[0].clone()
    for g in range(1, pl.grid):
        total += rows[g]
    return p, total[:pl.n], total[pl.n]


@pytest.mark.parametrize("sm", SMS)
@pytest.mark.parametrize("name", SHAPES)
def test_emulated_partition_equals_plain_f64(name, sm):
    # every product once: the partitioned sums in f64 equal the plain
    # matvecs (the megakernel's plain version runs them through
    # dual_matvec_plain) to 1e-12 of the largest output
    pl, _ = _plan(name, sm)
    rng = np.random.default_rng(9)
    a, x, y = (torch.from_numpy(v) for v in (
        rng.normal(size=(pl.m, pl.n)), rng.normal(size=pl.n),
        rng.normal(size=pl.m)))
    p, q, ysum = _emulate(a, x, y, pl)
    pp, qp = dm.dual_matvec_plain(a, x, y)
    scale = max(float(pp.abs().max()), float(qp.abs().max()))
    assert float((p - pp).abs().max()) <= 1e-12 * scale
    assert float((q - qp).abs().max()) <= 1e-12 * scale
    assert abs(float(ysum - y.sum())) <= 1e-12 * float(y.abs().sum())


def test_solve_mega_cuda_refuses_cpu_tensors():
    # the CUDA entry point never runs the plain version or the CPU
    m, n, cone = 4, 2, tt.ConeLayout([tt.rpos(4)])
    z = torch.zeros
    args = (z(m, n), z(n), z(m), z(n), z(m), (z(n), z(m), z(m), z(())),
            (z(n), z(m), z(())), (z(n), z(m), z(m), z(())),
            (z(n), z(m), z(())), cone)
    with pytest.raises(ValueError, match="CUDA"):
        mk.solve_mega_cuda(*args, eps_acc=1e-3, eps_inf=1e-6, eps_zero=1e-12,
                           max_iter=10, check_period=5)


#: the smoke's batched megakernel cells (phase 36): (shape, lanes)
BATCHES = [("lp100", 8), ("lp100", 64), ("qp50", 512), ("growth", 32)]


@pytest.mark.parametrize("name,lanes", BATCHES)
def test_plan_batch_covers_every_lane_and_stays_resident(name, lanes):
    # each lane's plan covers every row once with whole blocks; a
    # cooperative launch (G > 1) holds lanes x G CTAs within the SMs, one
    # CTA per SM; past the SMs each lane gets one CTA, in waves
    m, n, cone = _shape(name)
    tables = mk.cone_tables(cone)
    bp = mk.plan_batch(lanes, m, n, tables, 132, SMEM)
    pl = bp.plan
    assert pl.row_off[0] == 0 and pl.row_off[-1] == m
    assert all(a < b for a, b in zip(pl.row_off, pl.row_off[1:]))
    cuts = set(int(x) for x in mk._cut_points(m, tables[1], tables[2]))
    assert set(pl.row_off) <= cuts
    assert bp.ctas == lanes * pl.grid
    if bp.cooperative:
        assert bp.ctas <= 132 and bp.waves == 1
    else:
        assert pl.grid == 1 and bp.waves == -(-lanes // 132)
    assert pl.smem_bytes + mk.STATIC_SMEM <= SMEM
    # a lane's G is what the single plan picks on the SMs it may use
    assert pl == mk.plan(m, n, tables, max(1, 132 // lanes) if lanes <= 132
                         else 132, SMEM, grid=None if lanes <= 132 else 1)
    assert f"{lanes} lanes" in bp.describe()


def test_plan_batch_main_path_regimes():
    # batch8 and batch64 of the n=100 LP and the 32 growth portfolios are
    # cooperative with G > 1; 512 QP lanes are one CTA each, 4 waves
    tables = mk.cone_tables(_shape("lp100")[2])
    assert mk.plan_batch(8, 400, 100, tables, 132, SMEM).grid == 4
    assert mk.plan_batch(64, 400, 100, tables, 132, SMEM).grid == 2
    assert mk.plan_batch(66, 400, 100, tables, 132, SMEM).grid == 2
    assert mk.plan_batch(67, 400, 100, tables, 132, SMEM).grid == 1
    m, n, cone = _shape("qp50")
    bp = mk.plan_batch(512, m, n, mk.cone_tables(cone), 132, SMEM)
    assert not bp.cooperative and bp.waves == 4
    # one lane is the single solve's plan
    assert mk.plan_batch(1, 400, 100, tables, 132, SMEM).plan \
        == mk.plan(400, 100, tables, 132, SMEM)


def test_plan_batch_is_pure_and_refuses_bad_input():
    m, n, cone = _shape("growth")
    tables = mk.cone_tables(cone)
    assert mk.plan_batch(32, m, n, tables, 132, SMEM) \
        == mk.plan_batch(32, m, n, tables, 132, SMEM)
    for bad in (dict(lanes=0), dict(sm_count=0)):
        kw = dict(lanes=32, m=m, n=n, tables=tables, sm_count=132,
                  smem_per_block=SMEM)
        kw.update(bad)
        with pytest.raises(ValueError, match="plan_batch"):
            mk.plan_batch(**kw)
    # a forced G must stay resident; G = 1 always may
    with pytest.raises(ValueError, match="resident"):
        mk.plan_batch(32, m, n, tables, 132, SMEM, grid=5)
    assert mk.plan_batch(32, m, n, tables, 132, SMEM, grid=4).grid == 4
    assert mk.plan_batch(500, m, n, tables, 132, SMEM, grid=1).waves == 4
