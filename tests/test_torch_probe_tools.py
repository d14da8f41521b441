"""Port vs JAX: the probe tools' kernels T1-T3 and the four port tools.

T2 (`kernels/rowcopy.py`): each variant's plain result against the JAX
tool's Pallas kernel (`tools/dma_bench.py:make_variant`) in interpret mode,
at rows = 256, on the data its `build()` makes (without its pin_platform):
the same f32 adds in the same order, so equal; the rows variant also on
the two yardstick id sets that chip_smoke.py times (`yardstick_ids`), and
the plain model of which chunks each CTA of the persistent grid walks.
T3 (`kernels/stream_sum.py`): the plain stream against its Pallas body's
definition (a sum over rows), in float64 numpy; the payload sorts sorted and
carrying their payloads. The JAX kernel is defined inside the tool's main()
and cannot be imported.
T1 (`kernels/copy_probe.py`): each probe's plain version against what its
Pallas body writes, stated in numpy (the JAX probes only compile, on a TPU);
`launch_shape`'s cut of each probe's copy into CTAs, aligned and not.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guava_renderer_tpu_torch.kernels import copy_probe as kcp
from guava_renderer_tpu_torch.kernels import rowcopy as krc
from guava_renderer_tpu_torch.kernels import stream_sum as kss
from guava_renderer_tpu_torch.tools import dma_bench, ee_probe, mosaic_probe, sort_payload_bench

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ROWS = 256
VARIANTS = [("contig", 1), ("rows", 1), ("rows", 4), ("rows_pipe", 1), ("contig_pipe", 1),
            ("rows_pipe_bf16", 1), ("rows_pipe_2rows", 1)]


def _jax_dma_bench():
    spec = importlib.util.spec_from_file_location("jax_dma_bench", ROOT / "tools" / "dma_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_build(rows, p_rows):
    """tools/dma_bench.py:build without its pin_platform: the same draws."""
    rng = np.random.default_rng(0)
    table = np.asarray(jnp.asarray(rng.uniform(0, 1, (p_rows, 128)), jnp.float32))
    idx = rng.integers(0, p_rows - 2, rows).astype(np.int32)
    M = -(-rows // 128) + 2
    idx2d = np.zeros((M, 128), np.int32)
    idx2d.reshape(-1)[:rows] = idx
    return table, idx2d


def p_rows_of(name):
    """1024 rows; the contiguous variants read up to row (7 * 7 + 1) * 32 =
    1600 at 8 chunks, so they get 2048 (see test_contig_past_the_table_is_refused)."""
    return 2048 if name.startswith("contig") else 1024


@pytest.mark.parametrize("name,banks", VARIANTS)
def test_row_copy_plain_vs_jax_dma_bench(name, banks):
    table, idx2d = jax_build(ROWS, p_rows_of(name))
    want = np.asarray(_jax_dma_bench().make_variant(name, banks, ROWS)(
        jnp.asarray(idx2d), jnp.asarray(table)))
    t = krc.variant_table(torch.tensor(table), name)
    got, staged = krc.row_copy(t, torch.tensor(idx2d).reshape(-1), name, banks, ROWS, check=True)
    assert got.dtype == torch.float32 and got.shape == (1, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    # the rows as staged, stated from the JAX kernels' copies
    idx = idx2d.reshape(-1)[:ROWS].astype(np.int64).reshape(-1, krc.G)
    g = np.arange(krc.G)
    if name.startswith("contig"):
        ids = (np.arange(ROWS // krc.G)[:, None] * 7 % 1024) * krc.G + g
    elif name == "rows_pipe_2rows":
        ids = idx[:, g - g % 2] + g % 2
    else:
        ids = idx
    np.testing.assert_array_equal(staged.float().numpy(), t.float().numpy()[ids.reshape(-1)])


@pytest.mark.parametrize("key", ["perm", "hot"])
def test_row_copy_yardsticks_vs_jax_dma_bench(key):
    """The rows variant on the yardstick ids (`dma_bench.yardstick_ids`):
    its plain result against the JAX tool's rows kernel in interpret mode
    on the same ids, and its staged rows against index_select."""
    p_rows = 1024
    table, _ = jax_build(ROWS, p_rows)
    ids = dma_bench.yardstick_ids(ROWS, p_rows, "cpu")[key]
    idx2d = np.zeros((ROWS // 128 + 2, 128), np.int32)
    idx2d.reshape(-1)[:ROWS] = ids.numpy()
    want = np.asarray(_jax_dma_bench().make_variant("rows", 1, ROWS)(
        jnp.asarray(idx2d), jnp.asarray(table)))
    t = krc.variant_table(torch.tensor(table), "rows")
    got, staged = krc.row_copy(t, torch.tensor(idx2d).reshape(-1), "rows", 1, ROWS, check=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(staged, t.index_select(0, ids.long()))


def test_yardstick_ids():
    """perm: distinct rows of the table (every row at rows = p_rows); hot:
    rows below HOT_ROWS; the same draws each call."""
    y = dma_bench.yardstick_ids(4096, 4096, "cpu")
    assert torch.equal(torch.sort(y["perm"]).values, torch.arange(4096, dtype=torch.int32))
    big = dma_bench.yardstick_ids(2 * dma_bench.HOT_ROWS, 4 * dma_bench.HOT_ROWS, "cpu")
    assert int(big["hot"].max()) < dma_bench.HOT_ROWS and int(big["hot"].min()) >= 0
    assert int(torch.unique(big["perm"]).numel()) == 2 * dma_bench.HOT_ROWS
    assert all(v.dtype == torch.int32 for v in big.values())
    assert torch.equal(dma_bench.yardstick_ids(4096, 4096, "cpu")["hot"], y["hot"])
    with pytest.raises(ValueError, match="distinct"):
        dma_bench.yardstick_ids(5000, 4096, "cpu")


def cta_chunks(n_chunks, n_ctas):
    """The chunks each CTA of `csrc/dma_bench.cu:row_copy_kernel` walks, in
    order (its c_begin and n)."""
    return [range(n_chunks * b // n_ctas, n_chunks * (b + 1) // n_ctas) for b in range(n_ctas)]


@pytest.mark.parametrize("n_chunks,n_ctas", [(5, 8), (8, 8), (8192, 792), (100, 7), (1, 1),
                                             (8191, 1188)])
def test_row_copy_chunk_walk(n_chunks, n_ctas):
    """The plain model of the kernel's walk: each CTA a contiguous run, in
    order; together every chunk exactly once, with fewer, as many and more
    chunks than CTAs and a count that is no multiple of the CTAs."""
    runs = cta_chunks(n_chunks, n_ctas)
    assert len(runs) == n_ctas
    assert [c for r in runs for c in r] == list(range(n_chunks))
    sizes = [len(r) for r in runs]
    assert max(sizes) - min(sizes) <= 1


def test_row_copy_grid():
    """The persistent grid: the resident CTAs of the card, at most one a chunk."""
    assert krc.grid_ctas(8192, 132, 6) == 792
    assert krc.grid_ctas(100, 132, 6) == 100
    assert krc.grid_ctas(0, 132, 9) == 1


@pytest.mark.parametrize("name", ["rows", "rows_pipe_2rows"])
def test_row_copy_copies_alone(name):
    """total=False (what the bench times) stages the same rows and gives no output."""
    table, idx2d = jax_build(ROWS, 1024)
    t, idx = torch.tensor(table), torch.tensor(idx2d).reshape(-1)
    out, staged = krc.row_copy(t, idx, name, 1, ROWS, check=True, total=False)
    assert out is None
    torch.testing.assert_close(staged, krc.row_copy(t, idx, name, 1, ROWS, check=True)[1],
                               rtol=0, atol=0)


def test_contig_past_the_table_is_refused():
    """At 8 chunks the contiguous variants read rows up to 1600: past a
    1024-row table, which the JAX interpreter clamps (ROADMAP.md §3) and the
    port refuses."""
    table, idx2d = jax_build(ROWS, 1024)
    for name in ("contig", "contig_pipe"):
        with pytest.raises(ValueError, match="reads rows up to 1600"):
            krc.row_copy(torch.tensor(table), torch.tensor(idx2d).reshape(-1), name, 1, ROWS)


def test_row_copy_checks_its_arguments():
    table, idx2d = jax_build(ROWS, 1024)
    t, idx = torch.tensor(table), torch.tensor(idx2d).reshape(-1)
    with pytest.raises(ValueError, match="unknown variant"):
        krc.row_copy(t, idx, "rowsB4", 1, ROWS)
    with pytest.raises(ValueError, match="bfloat16 table"):
        krc.row_copy(t, idx, "rows_pipe_bf16", 1, ROWS)
    with pytest.raises(ValueError, match="banks"):
        krc.row_copy(t, idx, "rows", 3, ROWS)


def test_stream_sum_plain_vs_pallas_body():
    """sum over the rows of (M, 128), against float64 numpy, rel 1e-6."""
    rng = np.random.default_rng(0)
    table = rng.uniform(0, 1, (16 * kss.BLOCK, 128)).astype(np.float32)
    got = kss.stream_sum(torch.tensor(table))
    assert got.shape == (1, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), table.astype(np.float64).sum(0, keepdims=True),
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="multiple of 512"):
        kss.stream_sum(torch.tensor(table[:100]))


def test_payload_sort_sorts_and_carries():
    rng = np.random.default_rng(3)
    key = rng.integers(0, 64, 1000).astype(np.int32)          # many ties
    pay = [rng.uniform(0, 1, 1000).astype(np.float32), np.arange(1000, dtype=np.int32)]
    out = sort_payload_bench.payload_sort(torch.tensor(key), *map(torch.tensor, pay))
    perm = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(out[0].numpy(), key[perm])
    for got, p in zip(out[1:], pay):
        np.testing.assert_array_equal(got.numpy(), p[perm])


def pallas_probe_writes(name, src, at):
    """What each tools/mosaic_probe.py Pallas body writes to its output,
    stated in numpy: the copied window's first id (idx32, idx1024), id
    q = p % 128 + 31 of the two rows at p // 128 (idx2d), the row (row1,
    row64), the 32 rows (row1_loop), the 8-row window's first row (row8)."""
    if name == "idx32":
        return src[at:at + 32][None, :1]
    if name == "idx1024":
        return src[at:at + 1024][None, :1]
    if name == "idx2d":
        window = src[at // 128:at // 128 + 2]
        q = at % 128 + 31
        return window[q // 128, q % 128].reshape(1, 1)
    if name == "row1_loop":
        return src[at]
    if name == "row8":
        return src[(at // 8) * 8:(at // 8) * 8 + 8][:1]
    return src[at:at + 1]


@pytest.mark.parametrize("name", kcp.PROBES)
def test_copy_probe_plain_vs_pallas_bodies(name):
    """row1_loop's JAX body reads SMEM indices it never fills (its output is
    undefined, ROADMAP.md §3); the port's probe takes its 32 ids as an input."""
    src, at = mosaic_probe.probe_inputs(name, "cpu")
    got = kcp.copy_probe(name, src, at)
    at_np = at.numpy().astype(np.int64) if name == "row1_loop" else at
    np.testing.assert_array_equal(got.numpy(), pallas_probe_writes(name, src.numpy(), at_np))
    assert got.shape == kcp.plan(name, at).out_shape
    assert kcp.route(name, at) == "bulk"


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("name", kcp.PROBES)
def test_copy_probe_library_call(name, unaligned):
    """The one PyTorch call timed beside each probe writes the probe's values."""
    src, at = mosaic_probe.probe_inputs(name, "cpu", unaligned)
    want = kcp.copy_probe_plain(name, src, at)
    torch.testing.assert_close(mosaic_probe.library_call(name, src, at)().reshape(want.shape),
                               want, rtol=0, atol=0)


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("name", kcp.PROBES)
def test_copy_probe_launch_shape(name, unaligned):
    """launch_shape partitions the probe's copy as csrc/copy_probe.cu cuts it:
    segment c in CTA c, a CTA's shared memory (whole 128-byte lines, at most
    16 KB) at least what lands in it, the output window inside what lands,
    and the CTAs' parts of the window tiling it. row1_loop's rows go to a
    CTA each."""
    src, at = mosaic_probe.probe_inputs(name, "cpu", unaligned)
    c = kcp.plan(name, at)
    shape = kcp.launch_shape(name, at)
    assert shape.ctas == c.n_seg == (kcp.LOOP_ROWS if name == "row1_loop" else 1)
    assert c.seg_bytes <= shape.smem_bytes <= kcp.MAX_SMEM
    assert shape.smem_bytes % 128 == 0
    out_bytes = 4 * int(np.prod(c.out_shape))
    assert 0 <= c.out_off and c.out_off + out_bytes <= c.n_seg * c.seg_bytes
    parts = []
    for seg in range(shape.ctas):
        lo, hi = seg * c.seg_bytes, (seg + 1) * c.seg_bytes
        a, b = max(c.out_off, lo), min(c.out_off + out_bytes, hi)
        if b > a:
            parts.append((a, b))
    assert parts[0][0] == c.out_off and parts[-1][1] == c.out_off + out_bytes
    assert all(p[1] == q[0] for p, q in zip(parts, parts[1:]))


def test_copy_probe_routes():
    """An index slice starting off a 16-byte boundary takes 4-byte cp.async;
    rows of 256 or 512 bytes take the bulk engine at any index."""
    assert kcp.route("idx32", 4097) == kcp.route("idx1024", 8193) == "async4"
    assert kcp.route("idx32", 4100) == "bulk"
    assert kcp.route("row64", 1) == kcp.route("row1", 3) == kcp.route("idx2d", 5) == "bulk"
    src, _ = mosaic_probe.probe_inputs("idx32", "cpu")
    with pytest.raises(ValueError, match="outside"):
        kcp.copy_probe("idx32", src, 65536 - 16)


def test_ee_probe_main_on_cpu(capsys):
    res = ee_probe.main(["--device", "cpu", "--size", "64", "--uv", "32", "--body-side", "12",
                         "--head-side", "6", "--tile", "16", "--variants", "1:8,4:8",
                         "--iters", "1"])
    out = capsys.readouterr().out
    assert "[ee] counts exit_every=1 chunk=32: run=" in out
    assert "[ee] blend exit_every=4 chunk=8: not measured (cpu)" in out
    run, total = res["counts"][1]
    assert 0 < run <= total and [v["chunk"] for v in res["variants"]] == [8, 8]


def test_dma_bench_main_on_cpu(capsys):
    spec = ",".join(f"{n}:{b}" for n, b in VARIANTS)
    res = dma_bench.main(["--device", "cpu", "--rows", "256", "--p-rows", "2048", "--variants",
                          spec])
    out = capsys.readouterr().out
    assert out.count("steady=not measured (cpu)") == len(VARIANTS)
    rows = {(r["name"], r["banks"]): r["value"] for r in res}
    assert rows["rows", 1] == rows["rows", 4] == rows["rows_pipe", 1] == rows["rows_pipe_2rows", 1]
    assert rows["contig", 1] == rows["contig_pipe", 1]


def test_sort_payload_bench_main_on_cpu(capsys):
    res = sort_payload_bench.main(["--device", "cpu", "--rows", "2048", "--p", "512"])
    out = capsys.readouterr().out
    assert all(res["sorted"].values()) and len(res["sorted"]) == 5
    assert "[decision    ] not measured" in out
    np.testing.assert_allclose(res["stream"]["out"].numpy(),
                               res["stream"]["table"].double().sum(0, keepdim=True).numpy(),
                               rtol=1e-6)


def test_mosaic_probe_main_on_cpu(capsys):
    """The subprocess path, one probe (a process each costs an import of torch)."""
    res = mosaic_probe.main(["--device", "cpu", "--exp", "idx32", "--unaligned", "--iters", "1"])
    assert capsys.readouterr().out.startswith("EXP idx32 OK route=async4 err=0 launches=0")
    assert res == [{"name": "idx32", "ok": True, "route": "async4", "err": 0.0, "launches": 0,
                    "ms": None, "plain_ms": None, "library_ms": None, "bytes": 132,
                    "library_bytes": 8, "floor_ms": None}]


@pytest.mark.parametrize("name", kcp.PROBES)
def test_copy_probe_moved_bytes(name):
    """What a probe and its library call must move: the probe its copied
    segments and its output, the call its output read and written. Only the
    row probes that copy exactly the row they write (row1, row64, row1_loop)
    move the same data bytes both ways."""
    src, at = mosaic_probe.probe_inputs(name, "cpu")
    probe, library = mosaic_probe.moved_bytes(name, at)
    out = kcp.copy_probe_plain(name, src, at)
    out_bytes = out.numel() * out.element_size()
    copied = {"idx32": 128, "idx1024": 4096, "idx2d": 1024, "row1": 512, "row1_loop": 16384,
              "row8": 4096, "row64": 256}[name]
    ids = 128 if name == "row1_loop" else 0
    assert probe == copied + ids + out_bytes
    assert library == 2 * out_bytes + 2 * ids
    assert (copied == out_bytes) == (name in ("row1", "row64", "row1_loop"))
