"""K5's staged body (``csrc/markov_features_longT.cu``) emulated on the
CPU, and its host plan.

The body: persistent blocks take the tiles b, b + G, ... of nt instances;
a block's walk is one sequence of windows (a tile's steps W at a time,
tile after tile), each window copied into stage g % ns of a ring, ns - 1
windows ahead of the build.  A window holds, for each of its steps, the
d rows of z_t and the l rows of x_t over the tile, each row copied in
16-byte pieces from its aligned start (one piece more a row where a row
can start inside a 16-byte line); a piece that starts past the array is
zero-filled.  The build reads element j of a row at the row's offset
inside its first line plus j.  q threads an instance: q = 1 runs the three
row parts (``markov_longT_rows.cuh``: RowsZZ, RowsZN, RowsX) in one
thread, q = 3 a part a thread; the transition part runs one step behind
(its step t - 1 takes z_{t-1} and z_t, its last step z_{T-1} twice).
Each row is stored to Φ as it is finished (g6 and g10 at the first step).

The emulation below walks that loop in numpy (every product and sum
rounded on its own in the input's type, as the kernel's ``mul_rn`` and
``add_rn``) over a simulated device memory in which z_t and x_t may start
inside a 16-byte line, and is held bit for bit to
``markov_materialize_features_longT_plain``: every entry of Φ stored
exactly once, the pad rows zero, nothing stored past n, every ring read
from the window that the walk expects and from bytes that window copied.
The batch is unstandardized (|x| ~ 50), NaN past each length, from a
numpy seed, at a ragged n.  The JAX package's K5 is held to the plain
version in ``tests/test_torch_longT.py`` (interpret mode).

The plan (``markov_kernels.k5_plan``) fits a block within the card's
232 448 bytes for every d, l ≤ 8 in both types, or is None, which routes
the shape to the global-memory body."""

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu_torch.ops import markov_kernels as mk

MAX_SMEM = 232448
FIXED = ((5, 3), (2, 4), (2, 3), (3, 2), (1, 3), (1, 1))  # the compiled (d, l)
UNSET = 7.25e37  # a stage value no copy writes (the batch stays below 1e4)


def _batch(T, d, l, n, seed, dtype, scale=50.0):
    """(z_t (T·d, n), x_t (T·l, n), lens) in numpy: values N(0, 1) plus a
    per-coordinate offset, times ``scale``; lengths 0..T, NaN past each."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(T, n, d)) + rng.normal(size=d)) * scale
    x = (rng.normal(size=(T, n, l)) + rng.normal(size=l)) * scale
    lens = rng.integers(0, T + 1, size=n).astype(np.int32)
    past = np.arange(T)[:, None] >= lens[None, :]
    z[past], x[past] = np.nan, np.nan
    zt = np.ascontiguousarray(z.transpose(0, 2, 1).reshape(T * d, n)).astype(dtype)
    xt = np.ascontiguousarray(x.transpose(0, 2, 1).reshape(T * l, n)).astype(dtype)
    return zt, xt, lens


class Memory:
    """An array as the card holds it: ``base`` values into a 16-byte line
    (index 0 of ``mem`` starts a line), garbage around it."""

    def __init__(self, a, base, V):
        self.V, self.base, self.end = V, base, base + a.size
        self.mem = np.full(base + a.size + 2 * V, -3.5e4, a.dtype)
        self.mem[base:self.end] = a.ravel()

    def piece(self, at):
        """The 16 bytes at value index ``at`` (a line's start): zeros where
        the piece starts past the array (the zero-filled copy)."""
        assert at % self.V == 0
        if at >= self.end:
            return np.zeros(self.V, self.mem.dtype)
        assert at + self.V > self.base  # the line holds a value of the array
        return self.mem[at:at + self.V]


def emulate(zt, xt, lens, T, d, l, nt, q, W, ns, grid, bz=0, bx=0):
    """K5's staged walk: (Φ with NaN where nothing was stored, the stores of
    each entry, the stores past n)."""
    dtype = zt.dtype.type
    n = zt.shape[1]
    V = 16 // zt.itemsize
    R, P = d + l, nt + V
    o = mk._canonical_offsets(d, l)
    F_pad = mk._canonical_rows(d, l)
    mz, mx = Memory(zt, bz, V), Memory(xt, bx, V)
    extra = (n % V) or bz or bx
    phi = np.full(F_pad * n + 2 * nt * F_pad, np.nan, zt.dtype)  # Φ, then what lies past it
    stores = np.zeros(phi.size, np.int64)
    ntiles = -(-n // nt)
    nwin = -(-T // W)
    zero, one = dtype(0), dtype(1)
    for b in range(grid):
        mine = (ntiles - 1 - b) // grid + 1 if b < ntiles else 0
        nglob = mine * nwin
        stages = np.full((ns, W, R, P), UNSET, zt.dtype)
        holds = [None] * ns  # the window each stage holds
        read_upto = -1  # windows < read_upto are done

        def issue(g):
            if g >= nglob:
                return
            slot = g % ns
            assert holds[slot] is None or holds[slot] < read_upto, "a stage overwritten before its window was read"
            i0 = (b + (g // nwin) * grid) * nt
            t0 = (g % nwin) * W
            stages[slot] = UNSET
            for w in range(min(W, T - t0)):
                for r in range(R):
                    m, row = (mz, (t0 + w) * d + r) if r < d else (mx, (t0 + w) * l + r - d)
                    src = m.base + row * n + i0
                    start = src - src % V
                    for c in range(nt // V + (1 if extra else 0)):
                        stages[slot, w, r, c * V:(c + 1) * V] = m.piece(start + c * V)
            holds[slot] = g

        for g in range(ns - 1):
            issue(g)
        g = 0
        for it in range(mine):
            i0 = (b + it * grid) * nt
            lanes = np.arange(nt)
            i = i0 + lanes
            active = i < n
            ln = np.where(active, lens[np.minimum(i, n - 1)], 0)

            def put(row, v, part):
                at = row * n + i[active]
                phi[at] = v[active]
                stores[at] += 1
                # the storing thread: lane j of part p's warps (q = 3), or lane j
                tid = lanes[active] + {1: 0, 2: 1, 4: 2}[part] * nt * (q == 3)
                assert (owner[row, lanes[active]] < 0).all()
                owner[row, lanes[active]] = tid

            def vm_at(t):
                return ((ln > t + 1) & (t < T - 1)).astype(zt.dtype)

            owner = np.full((F_pad, nt), -1, np.int64)  # the thread that stored each row of each lane
            a1 = {(a, c): np.zeros(nt, zt.dtype) for a in range(d) for c in range(a, d)}
            a2 = {k: v.copy() for k, v in a1.items()}
            a3 = {(a, c): np.zeros(nt, zt.dtype) for a in range(d) for c in range(d)}
            a7, a8 = [np.zeros(nt, zt.dtype) for _ in range(d)], [np.zeros(nt, zt.dtype) for _ in range(d)]
            a4 = {(a, c): np.zeros(nt, zt.dtype) for a in range(l) for c in range(a, l)}
            a5 = {(a, c): np.zeros(nt, zt.dtype) for a in range(d) for c in range(l)}
            a9 = [np.zeros(nt, zt.dtype) for _ in range(l)]

            def sym(base, k, a, c, v, part):
                put(base + a * k + c, v, part)
                if c != a:
                    put(base + c * k + a, v, part)

            def step1(zc, zn, vm, first):  # RowsZN::step
                for a in range(d):
                    for c in range(d):
                        a3[a, c] = a3[a, c] + zc[a] * (zn[c] * vm)
                    a7[a] = a7[a] + vm * zc[a]
                    a8[a] = a8[a] + zc[a]
                    if first:
                        put(o["g10"] + a, zero + zc[a], 2)

            zp = None
            w = W
            for t in range(T):
                if w == W:  # enter(g)
                    assert holds[g % ns] == g, "the stage does not hold the expected window"
                    read_upto = g
                    issue(g + ns - 1)
                    slot = g % ns
                    g += 1
                    w = 0
                sl = stages[slot, w]

                def load(r, base, row):
                    off = (base + row * n) % V
                    v = sl[r, off:off + nt]
                    assert not (v[active] == UNSET).any(), "a read of bytes the window did not copy"
                    return np.where(np.isfinite(v), v, zero)

                zc = [load(a, bz, t * d + a) for a in range(d)]
                xc = [load(d + c, bx, t * l + c) for c in range(l)]
                vm = vm_at(t)
                for a in range(d):  # RowsZZ::step
                    for c in range(a, d):
                        zz = zc[a] * zc[c]
                        a1[a, c] = a1[a, c] + zz
                        a2[a, c] = a2[a, c] + vm * zz
                        if t == 0:
                            sym(o["g6"], d, a, c, zero + zz, 1)
                for a in range(l):  # RowsX::step
                    for c in range(a, l):
                        a4[a, c] = a4[a, c] + xc[a] * xc[c]
                    a9[a] = a9[a] + xc[a]
                for a in range(d):
                    for c in range(l):
                        a5[a, c] = a5[a, c] + zc[a] * xc[c]
                if t > 0:
                    step1(zp, zc, vm_at(t - 1), t == 1)
                zp = zc
                w += 1
            step1(zp, zp, vm_at(T - 1), T == 1)
            for (a, c), v in a1.items():  # RowsZZ::finish
                sym(o["g1"], d, a, c, v, 1)
                sym(o["g2"], d, a, c, a2[a, c], 1)
            for (a, c), v in a3.items():  # RowsZN::finish
                put(o["g3"] + a * d + c, v, 2)
            for a in range(d):
                put(o["g7"] + a, a7[a], 2)
                put(o["g8"] + a, a8[a], 2)
            for (a, c), v in a4.items():  # RowsX::finish
                sym(o["g4"], l, a, c, v, 4)
            for a in range(l):
                put(o["g9"] + a, a9[a], 4)
            for (a, c), v in a5.items():
                put(o["g5"] + a * l + c, v, 4)
            put(o["len"], zero + ln.astype(zt.dtype), 4)
            put(o["one"], np.full(nt, one), 4)
            for f in range(o["F"], F_pad):
                put(f, np.zeros(nt, zt.dtype), 4)
            # every row of an instance stored by one thread of the block: its
            # lane (q = 1), or the lane of the part that owns the row (q = 3)
            mine_rows = owner[:, active]
            assert (mine_rows >= 0).all() and (mine_rows % nt == lanes[active]).all() and (mine_rows < q * nt).all()
            if q == 3:
                assert len(np.unique(mine_rows // nt)) == 3
    return phi[: F_pad * n].reshape(F_pad, n), stores[: F_pad * n].reshape(F_pad, n), stores[F_pad * n:]


def _plain(zt, xt, lens, T, d, l):
    return mk.markov_materialize_features_longT_plain(
        *map(torch.from_numpy, (zt, xt, lens)), T=T, d=d, l=l).numpy()


def _same_bits(p, q):
    it = np.int32 if p.dtype == np.float32 else np.int64
    return p.dtype == q.dtype and np.array_equal(p.view(it), q.view(it))


# (steps a stage, stages, grid, base of z, base of x) on the plan's tile and
# threads an instance: the plan at a few grids (more blocks than tiles
# too), stages of 1 to 16 steps, rings of two and three, and bases off
# their 16-byte lines
_WALKS = [
    ("plan", 3, 0, 0), ("plan", 7, 1, 1), (1, 3, 5, 1, 3), (2, 2, 2, 0, 0), (4, 3, 4, 2, 0), (16, 2, 1, 0, 1),
]


@pytest.mark.parametrize("walk", range(len(_WALKS)))
@pytest.mark.parametrize("d,l", [(5, 3), (2, 4), (4, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_staged_walk_is_the_plain_version(dtype, d, l, walk):
    """Ragged n (301: no tile is whole at the end), T = 9 (a part-filled
    last window), lengths 0..T: every Φ entry stored once and nothing past
    n, the pad rows zero, Φ the plain version's bit for bit."""
    T, n = 9, 301
    zt, xt, lens = _batch(T, d, l, n, seed=100 * d + l, dtype=dtype)
    want = _plain(zt, xt, lens, T, d, l)
    p = mk.k5_plan(d, l, torch.float32 if dtype == np.float32 else torch.float64)
    V = 16 // zt.itemsize
    spec = _WALKS[walk]
    W, ns, grid, bz, bx = (p.steps, p.stages, *spec[1:]) if spec[0] == "plan" else spec
    got, stores, past = emulate(zt, xt, lens, T, d, l, p.nt, p.q, W, ns, grid, bz % V, bx % V)
    assert (stores == 1).all() and (past == 0).all()
    assert _same_bits(got, want)
    assert (got[mk._canonical_offsets(d, l)["F"]:] == 0).all()
    assert np.abs(zt[np.isfinite(zt)]).max() > 40.0


@pytest.mark.parametrize("T,n", [(1, 37), (2, 64), (16, 130)])
def test_staged_walk_at_short_T_and_whole_tiles(T, n):
    """T = 1 (the transition part's first step is its last: z_0 twice), T
    = 2, and n a whole number of tiles (no piece past the array)."""
    d, l = 5, 3
    zt, xt, lens = _batch(T, d, l, n, seed=T + n, dtype=np.float32)
    want = _plain(zt, xt, lens, T, d, l)
    for nt, q, W, ns, grid in ((128, 1, 4, 3, 2), (64, 3, 1, 2, 1)):
        got, stores, past = emulate(zt, xt, lens, T, d, l, nt, q, W, ns, grid)
        assert (stores == 1).all() and (past == 0).all()
        assert _same_bits(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_plan_fits_every_shape(dtype):
    """Every d, l ≤ 8: a block within 232 448 bytes (its shared memory the
    CUDA source's product), 32, 64 or 128 instances a tile, one thread an
    instance in float32 at the compiled (d, l) on 128-instance tiles, else
    three on 64-instance tiles, two or three stages; or None, and then the
    global-memory body."""
    itemsize = 4 if dtype == torch.float32 else 8
    for d in range(1, 9):
        for l in range(1, 9):
            plan = mk.k5_plan(d, l, dtype)
            if plan is None:
                assert mk._k5_body(d, l, dtype) == "global"
                continue
            assert plan.smem == mk.k5_smem(itemsize, plan.nt, d + l, plan.steps, plan.stages) <= MAX_SMEM
            assert plan.stages in (2, 3) and 1 <= plan.steps <= 16
            assert plan.q == (1 if dtype == torch.float32 and (d, l) in FIXED else 3)
            assert plan.nt == (128 if plan.q == 1 else 64)
            assert plan.threads == plan.q * plan.nt
            assert mk._k5_body(d, l, dtype) == "staged"


def test_k5_plan_none_routes_the_global_body(monkeypatch):
    """Past the kernel's d, l ≤ 8, or in another type, no plan; where the
    plan is None the wrapper takes the global-memory body."""
    assert mk.k5_plan(9, 3, torch.float32) is None and mk.k5_plan(5, 3, torch.float16) is None
    assert mk._k5_body(5, 3, torch.float32) == "staged"
    monkeypatch.setattr(mk, "k5_plan", lambda d, l, dtype: None)
    assert mk._k5_body(5, 3, torch.float32) == "global"


def test_k5_plan_at_the_bench_and_adni_shapes():
    """(5, 3) and ADNI's (2, 4) in float32: 128-instance tiles, one thread
    an instance, two stages of 8 steps (67 584 and 50 688 bytes); float64
    and the generic instantiation: 64-instance tiles, three threads an
    instance."""
    assert mk.k5_plan(5, 3, torch.float32) == mk.K5Plan(128, 1, 8, 2, 67584, 128)
    assert mk.k5_plan(2, 4, torch.float32) == mk.K5Plan(128, 1, 8, 2, 50688, 128)
    assert mk.k5_plan(5, 3, torch.float64) == mk.K5Plan(64, 3, 8, 2, 67584, 192)
    assert mk.k5_plan(4, 4, torch.float32) == mk.K5Plan(64, 3, 8, 2, 34816, 192)
