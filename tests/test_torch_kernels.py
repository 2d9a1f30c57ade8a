"""The port's decode kernels, plain versions on the CPU, held against the
JAX package's Pallas kernels (interpret mode) on the same numpy inputs.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.  Here the wrappers are checked
for refusing what the kernels do not take (every CUDA wrapper refuses an
input that requires grad), and, on a fake card (the library and the
device check stubbed), for launching the chunked kernel once per call
with its grid, scratch and tickets.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_splitk_cuda)

B, KV, D, S = 4, 2, 16, 64
POS = np.array([-1, 5, 40, S - 1], np.int32)  # parked, ragged, last row

# f32: both sides compute in f32 with different summation orders and the
# Pallas kernel's blocked online softmax; 1e-5 covers that reordering.
# bf16: the Pallas kernel rounds p to bf16 before PV while the plain
# version keeps f32, and the bf16 output itself carries ~3 significant
# digits; 2e-2 covers that.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(g, t, dtype, seed=0):
    rng = np.random.default_rng(seed)
    h = KV * g
    q = rng.normal(size=(B, t, h, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a, jdt) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return jx, tx


CASES = [(1, 1), (1, 2), (1, 4), (3, 1)]  # (T, num_splits); split-K at T=1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("t,ns", CASES)
def test_plain_decode_matches_pallas(t, ns, window, g, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(g, t, dtype)
    want = jax_decode(jq, jk, jv, jnp.asarray(POS), window=window,
                      block_k=16, num_splits=ns)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(POS),
                               window=window, num_splits=ns)
    assert got.shape == (B, t, KV * g, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert float(got[0].abs().max()) == 0.0  # parked slot writes zeros


@pytest.mark.parametrize("ns", [2, 4, 8])
def test_splitk_plain_version_equals_single_pass(ns):
    """The two-phase combine reproduces the single softmax (f32 rounding
    only), including a slot whose live prefix fits in the first split."""
    _, (tq, tk, tv) = _inputs(2, 1, "float32", seed=3)
    pos = torch.tensor([0, 7, 33, S - 1])
    qt, kt, vt = (x.transpose(1, 2) for x in (tq, tk, tv))
    one = ref.decode_attention_ref(qt, kt, vt, pos, window=24)
    split = ref.decode_attention_splitk_ref(qt, kt, vt, pos, window=24,
                                            num_splits=ns)
    torch.testing.assert_close(split, one, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("t,ns", [(1, 4), (3, 2)])
def test_plain_dispatch_splits_only_single_token(t, ns):
    """``decode_attention_plain`` (the CPU branch of the dispatch, and what
    the on-card checks compare the kernels with) takes split-K only at
    T = 1; T > 1 runs the single pass, as the reference does, one row at a
    time (row t the one-token call at pos + t under the block's active
    slots), so that a row does not depend on T."""
    _, (tq, tk, tv) = _inputs(2, t, "float32", seed=5)
    pos = torch.from_numpy(POS)
    got = ops.decode_attention_plain(tq, tk, tv, pos, window=24,
                                     num_splits=ns)
    qt, kt, vt = (x.transpose(1, 2) for x in (tq, tk, tv))
    if t == 1:
        want = ref.decode_attention_splitk_ref(qt, kt, vt, pos, window=24,
                                               num_splits=ns)
    else:
        want = torch.cat([ref.decode_attention_ref(
            qt[:, :, i:i + 1].contiguous(), kt, vt, pos + i,
            active=pos >= 0, window=24) for i in range(t)], dim=2)
    assert torch.equal(got, want.transpose(1, 2))
    assert torch.equal(ops.decode_attention(tq, tk, tv, pos, window=24,
                                            num_splits=ns), got)


def test_explicit_active_gates_slots():
    _, (tq, tk, tv) = _inputs(1, 1, "float32")
    pos = torch.tensor([3, 5, 40, S - 1])
    active = torch.tensor([1, 0, 1, 0])
    out = ops.decode_attention(tq, tk, tv, pos, active=active)
    full = ops.decode_attention(tq, tk, tv, pos)
    assert float(out[1].abs().max()) == 0.0
    assert float(out[3].abs().max()) == 0.0
    torch.testing.assert_close(out[0], full[0])
    torch.testing.assert_close(out[2], full[2])


@pytest.mark.parametrize("fn", [decode_attention_cuda,
                                decode_attention_splitk_cuda])
def test_cuda_wrappers_refuse_cpu_tensors(fn):
    """No hidden fallback: a wrapper never runs a plain version."""
    _, (tq, tk, tv) = _inputs(1, 1, "float32")
    before = fn.launches
    with pytest.raises(ValueError):
        fn(tq, tk, tv, torch.from_numpy(POS))
    assert fn.launches == before


def test_splitk_wrapper_refuses_multi_token():
    _, (tq, tk, tv) = _inputs(1, 3, "float32")
    with pytest.raises(ValueError, match="single-token"):
        decode_attention_splitk_cuda(tq, tk, tv, 3, num_splits=2)


# ------------------------------------------------- the launch, on a fake card
class _FakeLib:
    """Stands in for the built library: records each entry point's
    arguments and returns the error code it is given; ``head_dims`` lists
    the head dim of each library the wrappers asked for."""

    def __init__(self, err):
        self.err, self.calls, self.head_dims = err, [], []
        for name in ("decode_attention_fwd", "decode_attention_splitk_fwd"):
            setattr(self, name, self._entry(name))

    def load(self, head_dim):
        """The wrappers' ``_lib(head_dim)``: the library of that head dim
        (recorded)."""
        self.head_dims.append(head_dim)
        return self

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.err
        return call


def _fake_card(monkeypatch, err):
    """Run the dense wrappers on CPU tensors up to the launch: the device
    check and the stream are stubbed, the library is ``_FakeLib``, and the
    chunk scratch each launch allocates is recorded."""
    lib = _FakeLib(err)
    monkeypatch.setattr(tdecode, "_lib", lib.load)
    monkeypatch.setattr(tdecode, "_check_device", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    scratch, alloc = [], tdecode.chunk_scratch

    def record(rows, d, device):
        scratch.append(alloc(rows, d, device))
        return scratch[-1]

    monkeypatch.setattr(tdecode, "chunk_scratch", record)
    return lib, scratch


def _card_shaped(s, t):
    """q (2, t, 4, 128) and caches (2, s, 2, 128)."""
    k = torch.zeros((2, s, 2, 128))
    return torch.zeros((2, t, 4, 128)), k, k.clone()


# fwd and split-K: pointers (q, k, v, out, pos, active) 0-5, then ints:
# fwd B, T, H, KV, S, D, window; split-K B, H, KV, S, D, window, ns; then
# chunk 13, chunks per split 14, instance rows 15, row tiles 16, route 17,
# strides 18-20, o_part 21, ml_part 22, tickets 23, dtype codes 24-25,
# stream 26
@pytest.mark.parametrize("s", [520, 8192])
@pytest.mark.parametrize("t,ns", [(1, 1), (4, 1), (1, 2), (1, 4), (1, 8)])
def test_dense_wrappers_launch_the_chunked_kernel_once(t, ns, s,
                                                       monkeypatch):
    """One C call per wrapper call, split-K included (no combine launch),
    over ``decode_chunks(S, 1, ns)``'s grid, with f32 scratch of
    B * KV * n_chunks * G * T rows of D + 2 floats (accumulators, then
    (m, l)), G = 2 at head dim 128 on the warp-mma route (code 2) in one
    row tile of its 8-column instance, which holds G * T = 2 and 8 rows,
    and at least B * KV zeroed tickets."""
    q, k, v = _card_shaped(s, t)
    lib, scratch = _fake_card(monkeypatch, 0)
    wrapper = decode_attention_cuda if ns == 1 else \
        decode_attention_splitk_cuda
    kw = {} if ns == 1 else {"num_splits": ns}
    before = wrapper.launches
    out = wrapper(q, k, v, [3, s - 1], **kw)
    (name, args), = lib.calls
    assert name == ("decode_attention_fwd" if ns == 1
                    else "decode_attention_splitk_fwd")
    assert wrapper.launches == before + 1
    assert out.shape == q.shape and args[3] == out.data_ptr()
    chunk, cps, ranges = tdecode.decode_chunks(s, 1, ns)
    assert args[13:15] == (chunk, cps) and len(ranges) == ns * cps
    assert args[15:18] == (8, 1, 2)
    rows = 2 * 2 * len(ranges) * 2 * t  # B * KV * n_chunks * G * T
    (buf,) = scratch
    assert buf.dtype == torch.float32 and buf.numel() == rows * (128 + 2)
    assert args[21] == buf.data_ptr()
    assert args[22] == buf.data_ptr() + 4 * rows * 128
    tickets = tdecode._TICKETS[(q.device, 0)]
    assert args[23] == tickets.data_ptr() and tickets.numel() >= 2 * 2
    assert not tickets.any()
    assert args[24:26] == (0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [1, 2])
def test_dense_wrapper_reads_a_stacked_layer_slice_in_place(ns, dtype,
                                                            monkeypatch):
    """A layer's slice of the engine's stacked (L, B, S, KV, D) cache goes
    to the kernel as it is: its own pointer and its real strides, no copy;
    every layer's slice has 16-byte-aligned rows, as the kernel's 16-byte
    loads need."""
    s = 520
    stack = torch.zeros((3, 2, s, 2, 128), dtype=dtype)
    assert all(tdecode.rows_aligned(stack[i]) for i in range(3))
    q, k, v = torch.zeros((2, 1, 4, 128)), stack[2], stack[1]
    assert k.storage_offset() > 0  # a view into the stack, not a copy
    lib, _ = _fake_card(monkeypatch, 0)
    if ns == 1:
        decode_attention_cuda(q, k, v, 5)
    else:
        decode_attention_splitk_cuda(q, k, v, 5, num_splits=ns)
    (_, args), = lib.calls
    assert args[1:3] == (k.data_ptr(), v.data_ptr())
    assert list(args[19]) == list(k.stride()[:3]) == [s * 256, 256, 128]
    assert args[25] == {torch.float32: 0, torch.bfloat16: 1}[dtype]


@pytest.mark.parametrize("ns", [1, 2])
def test_dense_wrapper_raises_on_a_refused_launch(ns, monkeypatch):
    """A launch the kernel refuses (cudaErrorInvalidValue, 1) raises and
    counts no launch; nothing moves to a plain version."""
    q, k, v = _card_shaped(520, 1)
    lib, _ = _fake_card(monkeypatch, 1)
    wrapper = decode_attention_cuda if ns == 1 else \
        decode_attention_splitk_cuda
    kw = {} if ns == 1 else {"num_splits": ns}
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="launch failed: cudaError 1"):
        wrapper(q, k, v, [3, 9], **kw)
    assert wrapper.launches == before and len(lib.calls) == 1


# --------------------------------------------------------------- head dims
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("ns", [1, 2])
def test_dense_wrappers_reach_the_library_of_each_head_dim(ns, d,
                                                           monkeypatch):
    """Head dims 64 (musicgen), 80 (zamba2's shared block) and 128 load
    their own library and hand it D, with scratch of D + 2 floats per
    chunk row."""
    q = torch.zeros((2, 1, 2, d))
    k = torch.zeros((2, 520, 2, d))
    lib, scratch = _fake_card(monkeypatch, 0)
    if ns == 1:
        decode_attention_cuda(q, k, k.clone(), [3, 519])
    else:
        decode_attention_splitk_cuda(q, k, k.clone(), [3, 519],
                                     num_splits=ns)
    (_, args), = lib.calls
    assert lib.head_dims == [d]
    # fwd: B, T, H, KV, S, D at 6-11; split-K: B, H, KV, S, D at 6-10
    assert args[11 if ns == 1 else 10] == d
    (buf,) = scratch
    rows = 2 * 2 * len(tdecode.decode_chunks(520, 1, ns)[2])  # G * T = 1
    assert buf.numel() == rows * (d + 2)


@pytest.mark.parametrize("d,t,ok", [(80, 8, True), (80, 9, False),
                                    (64, 8, True), (64, 16, False),
                                    (128, 16, True), (128, 17, False)])
def test_dense_rows_per_head_dim(d, t, ok, monkeypatch):
    """The 8-row instance is the largest at head dims 64 and 80, the
    16-row one at 128: G * T rows up to it (``ok``) launch one row tile of
    it; more launch once in ceil(G * T / TILE_ROWS) row tiles, with a
    ticket per (slot, KV head, tile) and the scratch still G * T rows per
    chunk.  On an f32 cache head dim 64 takes the warp-mma route instead:
    8 rows one block of 8 columns, 16 rows one instance of 16."""
    assert tdecode.max_rows(d) == (16 if d == 128 else 8)
    q = torch.zeros((2, t, 2, d))
    k = torch.zeros((2, 64, 2, d))
    lib, scratch = _fake_card(monkeypatch, 0)
    out = decode_attention_cuda(q, k, k.clone(), [3, 9])
    (_, args), = lib.calls
    rt = tdecode.TILE_ROWS
    if d == tdecode.MMA64_HEAD_DIM:
        assert args[15:18] == ((tdecode.MMA_COLS, 1) if ok else
                               (tdecode.MMA64_ROWS, 1)) + (
            tdecode.ROUTES.index("warp_mma"),)
    else:
        assert args[15:17] == ((tdecode.max_rows(d), 1) if ok
                               else (rt, -(-t // rt)))
    tickets = tdecode._TICKETS[(q.device, 0)]
    assert args[23] == tickets.data_ptr()
    assert tickets.numel() >= 2 * 2 * args[16] and not tickets.any()
    (buf,) = scratch
    assert buf.numel() == 2 * 2 * len(tdecode.decode_chunks(64, 1)[2]) \
        * t * (d + 2)
    assert out.shape == q.shape


@pytest.mark.parametrize("d", [96, 112, 256])
def test_dense_wrappers_refuse_a_head_dim_not_built(d, monkeypatch):
    q = torch.zeros((2, 1, 2, d))
    k = torch.zeros((2, 64, 2, d))
    lib, _ = _fake_card(monkeypatch, 0)
    with pytest.raises(ValueError, match=f"head_dim {d} not built"):
        decode_attention_cuda(q, k, k.clone(), [3, 9])
    with pytest.raises(ValueError, match=f"head_dim {d} not built"):
        tdecode.max_rows(d)
    assert not lib.calls and not lib.head_dims


# ------------------------------------------- the wrappers refuse autograd
def _grad_calls():
    """Each CUDA wrapper called on CPU inputs (B=1, T=1, H=KV=2, D=16; a
    4-page pool; an SSD chunk of 32) of which one requires grad."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda, paged_decode_attention_splitk_cuda,
        paged_prefill_attention_cuda)
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda

    q = torch.randn(1, 1, 2, D, requires_grad=True)
    kv = torch.randn(1, 8, 2, D)
    pool = torch.randn(4, 4, 2, D)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    x = torch.randn(1, 1, 2, 32, 64, requires_grad=True)
    bc = torch.randn(1, 1, 1, 32, 32)
    dt = torch.rand(1, 1, 2, 32)
    return {
        "decode_attention_cuda":
            lambda: decode_attention_cuda(q, kv, kv, 3),
        "decode_attention_splitk_cuda":
            lambda: decode_attention_splitk_cuda(q, kv, kv, 3, num_splits=2),
        "paged_decode_attention_cuda":
            lambda: paged_decode_attention_cuda(q, pool, pool, table, 3),
        "paged_decode_attention_splitk_cuda":
            lambda: paged_decode_attention_splitk_cuda(q, pool, pool, table,
                                                       3, num_splits=2),
        "paged_prefill_attention_cuda":
            lambda: paged_prefill_attention_cuda(q, pool, pool, table[0], 0),
        "flash_attention_cuda":
            lambda: flash_attention_cuda(q, kv[:, :1].clone(),
                                         kv[:, :1].clone()),
        "ssd_chunk_cuda":
            lambda: ssd_chunk_cuda(x, bc, bc, dt, dt.cumsum(-1)),
    }


@pytest.mark.parametrize("name", sorted(_grad_calls()))
def test_cuda_wrappers_refuse_inputs_that_require_grad(name):
    """A kernel writes its output through ctypes into ``torch.empty``: no
    ``grad_fn``, so a gradient through it would vanish.  Every wrapper
    raises by name, before its device check (so here, on CPU tensors),
    when autograd would record the call; under ``no_grad`` the same call
    passes the guard and stops at the device check."""
    from repro_torch.kernels import flash_attention, paged_attention, ssd_scan

    call = _grad_calls()[name]
    fn = next(getattr(m, name) for m in (tdecode, paged_attention,
                                         flash_attention, ssd_scan)
              if hasattr(m, name))
    before = fn.launches
    with pytest.raises(RuntimeError, match=f"{name} is forward only"):
        call()
    with torch.no_grad(), pytest.raises(ValueError):
        call()
    assert fn.launches == before
