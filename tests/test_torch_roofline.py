"""The port's roofline counter (``repro_torch.launch.roofline``) and the
kernels' meta records (``kernels/ops.py``'s meta branch, ``cost.py``).

``TraceCounter`` on toy steps: exact matmul flops, free views, per-op
bytes, the peak of live bytes, and each collective's kind, bytes and
host/pod class on a fake (2, 16, 16) world; ``roofline`` on the
reference's three cases restated in H100 terms; ``model_flops`` equal to
the reference's on every cell; the reference's own HLO probe traced by
the port; each kernel's record against its cost function and its plain
version's output; ``fake_world``'s refusal.  The fake worlds live in this
process: ``fake_world`` refuses where a group exists and always destroys
its own."""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.core import h100  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.launch.mesh import (fake_world,  # noqa: E402
                                     make_production_mesh, make_serve_mesh)
from repro_torch.launch.roofline import (TraceCounter,  # noqa: E402
                                         model_flops, roofline)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------ the counter
def test_counter_matmul_flops_views_bytes_and_peak():
    """(M, K) @ (K, N) counts 2 M N K flops at the f32 rate class and its
    operands' and output's bytes; a transpose, a view and an expand are
    free; bf16 operands count in the bf16 class; the peak is the most
    bytes the step held at once, the arguments apart."""
    x, w = meta(64, 32), meta(32, 48)
    c = TraceCounter()
    assert c.track_args(x, {"w": [w]}) == (64 * 32 + 32 * 48) * 4
    with c:
        y = x @ w  # 64 x 48 f32: 12288 bytes
        z = y.t().reshape(48, 64).view(48, 8, 8)  # free
        e = z[:1].expand(4, 8, 8)  # free
        u = torch.tanh(z)  # 12288 read, 12288 written
        del y, z
        v = (u.bfloat16() @ meta(8, 16, dtype=torch.bfloat16))
        del u
    s = c.summary()
    assert s["flops_by_class"] == {"f32": 2 * 64 * 48 * 32,
                                   "bf16": 2 * 48 * 8 * 16 * 8}
    assert s["matmul_flops"] == s["flops"]
    mm = (64 * 32 + 32 * 48 + 64 * 48) * 4
    tanh = 2 * 64 * 48 * 4
    cast = 64 * 48 * (4 + 2)
    # the bf16 product of a 3-d by a 2-d operand runs as a bmm against
    # the weight expanded 48 times: its storage is read, not 48 copies
    bmm = (48 * 8 * 8 + 8 * 16 + 48 * 8 * 16) * 2
    assert s["hbm_bytes"] == mm + tanh + cast + bmm
    # e, a view of y, keeps y's storage: y, u, the bf16 copy, the weight
    # and the product's output at the end
    assert s["mem_temp_bytes"] == 2 * 64 * 48 * 4 + 64 * 48 * 2 + 8 * 16 \
        * 2 + 48 * 8 * 16 * 2
    assert s["mem_args_bytes"] == (64 * 32 + 32 * 48) * 4
    assert e.shape == (4, 8, 8) and v.dtype == torch.bfloat16


def test_counter_refuses_mixed_dtype_products():
    """The meta device does not check a matmul's operand dtypes; the card
    does, so the counter refuses what would fail there."""
    with TraceCounter(), pytest.raises(RuntimeError, match="mixed dtypes"):
        meta(4, 8) @ meta(8, 4, dtype=torch.bfloat16)


def test_counter_collectives_by_kind_bytes_and_span():
    """On the (2, 16, 16) production mesh at rank 0: the model axis (16
    ranks) spans two hosts of 8, the data axis 16 hosts, the pod axis two
    pods; a group inside one host is NVLink.  Each collective counts its
    output bytes under its kind and its span."""
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        host = dist.new_group(list(range(8)))
        c = TraceCounter(pod_size=256)
        with c:
            t = meta(4, 8)  # 128 bytes
            dist.all_reduce(t, group=mesh.get_group("model"))
            parts = [meta(4, 8) for _ in range(16)]
            dist.all_gather(parts, t, group=mesh.get_group("data"))
            dist.all_reduce(t, group=mesh.get_group("pod"))
            out = meta(16 * 4, 8)
            dist.all_to_all_single(out, meta(64, 8), group=host)
            dist.reduce_scatter_tensor(meta(4, 8), meta(32, 8), group=host)
        s = c.summary()
    assert not dist.is_initialized()
    assert s["per_kind"] == {"all-reduce": 256.0, "all-gather": 2048.0,
                             "all-to-all": 2048.0, "reduce-scatter": 128.0}
    assert s["by_span"] == {"hosts": 128.0 + 2048.0, "pods": 128.0,
                            "host": 2048.0 + 128.0}
    assert s["nvlink_bytes"] == 2176.0
    assert s["network_bytes"] == 2304.0
    assert s["n_collectives"] == 5


def test_fake_world_refuses_inside_a_group_and_leaves_none():
    with fake_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_world(4):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_world(8):
            raise ValueError("a failing body")
    assert not dist.is_initialized()


# ----------------------------------------------------------- the roofline
def test_roofline_terms_and_bottleneck():
    """The reference's cases (``tests/test_sharding_roofline.py``) on H100
    constants: one second each of bf16 compute, HBM and NVLink; three
    times the bytes make memory the bottleneck."""
    coll = {"nvlink_bytes": 450e9, "network_bytes": 0.0}
    t = roofline(989e12, 3.35e12, coll)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["nvlink_s"] == pytest.approx(1.0)
    assert t["step_s"] == pytest.approx(2.0)
    t2 = roofline(1e12, 3.35e12 * 3, coll)
    assert t2["bottleneck"] == "memory"
    t3 = roofline({"f32": 66.9e12, "bf16": 989e12}, 0.0, coll)
    assert t3["compute_s"] == pytest.approx(2.0)


def test_roofline_network_term_per_nic():
    """Every GPU has its own 50 GB/s NIC: 50 GB a device across hosts is
    one second, and the collective term is then the bottleneck."""
    t = roofline(0.0, 0.0, {"nvlink_bytes": 0.0, "network_bytes": 50e9})
    assert t["network_s"] == pytest.approx(1.0)
    assert t["bottleneck"] == "collective"


def test_h100_constants_and_rates():
    assert h100.TF32X3_FLOPS == pytest.approx(164.9e12, rel=1e-3)
    assert h100.TF32X2_FLOPS == pytest.approx(247.35e12, rel=1e-3)
    assert set(h100.RATES) == set(h100.RATE_NAMES)


def test_model_flops_equal_the_reference_every_cell():
    pytest.importorskip("jax")
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.launch.roofline import model_flops as jmodel_flops
    from repro_torch.configs import SHAPES, get_config, list_archs

    assert list(SHAPES) == list(JSHAPES)
    for arch in list_archs():
        for name, sh in SHAPES.items():
            assert model_flops(get_config(arch), sh) == jmodel_flops(
                jget_config(arch), JSHAPES[name]), (arch, name)


def test_reference_probe_flops_traced_by_the_port():
    """The reference's HLO probe (``tests/test_sharding_roofline.py``): 7
    scanned steps of (M/2 x K) @ (K x K) on a (2, 4) mesh, the rows cut
    over "data", the result gathered whole.  At rank 0 of a fake (2, 4)
    world the port counts 7 * 2 * 32^3 flops per device, what
    ``analyze_hlo`` counts in the reference's compiled module, and one
    all-gather over "data" inside a host."""
    pytest.importorskip("jax")
    from repro.launch.roofline import analyze_hlo
    from test_sharding_roofline import _PROBE

    hlo = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=300).stdout
    want = analyze_hlo(hlo)["flops"]
    from repro_torch.sharding.collectives import all_gather_cat

    L, M, K = 7, 64, 32
    with fake_world(8):
        mesh = make_serve_mesh((2, 4))
        x, w = meta(M // 2, K), meta(K, K)  # rank 0's rows of x
        c = TraceCounter()
        with c:
            for _ in range(L):
                x = torch.tanh(x @ w)
            out = all_gather_cat(x, mesh.get_group("data"), 0)
        s = c.summary()
    assert out.shape == (M, K)
    assert s["flops"] == 7 * 2 * 32 * 32 * 32 == want
    assert s["per_kind"] == {"all-gather": M // 2 * K * 4 * 2}
    assert s["by_span"] == {"host": M * K * 4}


# ------------------------------------------------- the kernels' meta branch
H, KV, D, B, S = 4, 2, 16, 3, 40


def _recorded(fn):
    got = []
    with cost.recording(lambda name, work: got.append((name, work))):
        out = fn()
    assert len(got) == 1
    return out, got[0]


def _pairs(rows, causal_len):
    return sum(causal_len(i) for i in range(rows))


@pytest.mark.parametrize("t", [1, 3])
def test_decode_meta_record(t):
    """#1 (T = 1, 3) and #2 (2 splits): every slot at the cache's last row
    (positions on meta are not known), 4 D flops per attended (row, key)
    pair on the CUDA cores, the whole K/V and q read once, the output
    written once; the plain version's output shape.  Host positions count
    as given."""
    q, k = meta(B, t, H, D), meta(B, S, KV, D)
    out, (name, w) = _recorded(lambda: ops.decode_attention(
        q, k, k, torch.zeros(B, dtype=torch.int32, device="meta")))
    want = ops.decode_attention_plain(torch.zeros(B, t, H, D),
                                      torch.zeros(B, S, KV, D),
                                      torch.zeros(B, S, KV, D),
                                      torch.full((B,), S - 1))
    assert name == "decode_attention" and out.shape == want.shape
    pairs = B * sum(min(S - 1 + i + 1, S) for i in range(t))
    assert w.flops == {"f32": 4 * D * H * pairs}
    live = B * S
    assert w.bytes_read == 2 * live * KV * D * 4 + B * t * H * D * 4 + 4 * B
    assert w.bytes_written == B * t * H * D * 4
    if t == 1:
        _, (name, w2) = _recorded(lambda: ops.decode_attention(
            q, k, k, [5, -1, 30], num_splits=2))
        assert name == "decode_attention_splitk"
        assert w2.flops == {"f32": 4 * D * H * (6 + 31)}


def test_paged_meta_records():
    """#3 against a page table of 5 pages of 8 (span 40) with int8 pools
    and scales (#3q): K/V bytes at one byte a value plus an f32 scale per
    key and KV head, the table's entries read; #4 (paged prefill) of a
    16-row chunk at offset 24: causal pairs at the 2xTF32 rate."""
    q = meta(B, 1, H, D)
    kp = meta(20, 8, KV, D, dtype=torch.int8)
    ks = meta(20, 8, KV, 1)
    table = meta(B, 5, dtype=torch.int32)
    out, (name, w) = _recorded(lambda: ops.paged_decode_attention(
        q, kp, kp, table, 7, k_scale=ks, v_scale=ks))
    assert name == "paged_decode_attention" and out.shape == q.shape
    assert w.flops == {"f32": 4 * D * H * B * 8}
    assert w.bytes_read == (2 * B * 8 * KV * (D + 4) + q.numel() * 4 + 4 * B
                            + 4 * B * 1)
    c, off = 16, 24
    qc = meta(1, c, H, D)
    out, (name, w) = _recorded(lambda: ops.paged_prefill_attention(
        qc, kp, kp, table, 0, off, k_scale=ks, v_scale=ks))
    assert name == "paged_prefill_attention" and out.shape == qc.shape
    keys = _pairs(c, lambda i: off + i + 1)
    assert w.flops == {"tf32x2": 4 * H * D * keys}
    assert w.bytes_read == (2 * (off + c) * KV * (D + 4) + qc.numel() * 4
                            + 4 * 5)


@pytest.mark.parametrize("dtype,window", [(torch.float32, 0),
                                          (torch.bfloat16, 12)])
def test_flash_meta_record(dtype, window):
    """#6: the attended pairs counted from the mask itself, at 3xTF32
    (f32) or the bf16 rate; the plain version's output shape."""
    q, k = meta(B, S, H, D, dtype=dtype), meta(B, S, KV, D, dtype=dtype)
    out, (name, w) = _recorded(lambda: ops.flash_attention(q, k, k,
                                                           window=window))
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    seen = (j <= i) & ((i - j < window) if window else True)
    rate = "bf16" if dtype == torch.bfloat16 else "tf32x3"
    assert w.flops == {rate: 4 * D * B * H * int(seen.sum())}
    es = q.element_size()
    assert w.bytes_read == (B * S * H * D + 2 * B * S * KV * D) * es
    want = ops.flash_attention_plain(torch.zeros(B, S, H, D),
                                     torch.zeros(B, S, KV, D),
                                     torch.zeros(B, S, KV, D), window=window)
    assert name == "flash_attention" and out.shape == want.shape
    assert out.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_meta_record(dtype):
    """#7: the lower triangle's products per chunk, at 3xTF32 for f32 and
    split bf16 / 2xTF32 for bf16; y in x's dtype and the f32 state, as the
    plain version returns them."""
    bb, nc, nh, g, q, hp, ds = 2, 3, 4, 1, 8, 16, 8
    args = (meta(bb, nc, nh, q, hp, dtype=dtype),
            meta(bb, nc, g, q, ds, dtype=dtype),
            meta(bb, nc, g, q, ds, dtype=dtype), meta(bb, nc, nh, q),
            meta(bb, nc, nh, q))
    (y, st), (name, w) = _recorded(lambda: ops.ssd_chunk(*args))
    plain = ops.ssd_chunk_plain(*[torch.zeros(a.shape, dtype=a.dtype)
                                  for a in args])
    assert name == "ssd_chunk"
    assert (y.shape, y.dtype, st.shape, st.dtype) == (
        plain[0].shape, plain[0].dtype, plain[1].shape, plain[1].dtype)
    pairs = q * (q + 1) // 2
    cb, ax = bb * nc * g * 2 * ds * pairs, bb * nc * nh * 2 * hp * pairs
    state = bb * nc * nh * 2 * q * ds * hp
    want = ({"tf32x3": cb + ax + state} if dtype == torch.float32
            else {"bf16": cb + ax, "tf32x2": state})
    assert w.flops == want


def test_kernel_bound_reads_the_h100_rates():
    """A kernel's bound is the larger of its bytes over 3.35 TB/s and its
    flops over each class's peak."""
    w = cost.Work({"tf32x3": 2 * 164.9e9}, 1.675e9, 1.675e9)
    ms, by, _ = w.bound()
    assert ms == pytest.approx(2.0) and by == "operations"
    w = cost.Work({"f32": 1e6}, 3.35e9, 0.0)
    assert w.bound()[:2] == (pytest.approx(1.0), "bytes")
