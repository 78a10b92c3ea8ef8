"""The launch plans of the CUDA LayerNorm and GroupNorm kernels
(``csrc/norms.cu``), read on the CPU (no nvcc, no card).  The plans are
pure Python in ``ops/layer_norm.py`` and ``ops/group_norm.py``: the
kernels take the grid, the cluster size, the mode and the shared memory
from them, and walk rows and channels by the same formulas as
``layer_norm_fwd_rows``, ``layer_norm_bwd_rows``, ``group_norm_bwd_rows``
and ``group_norm_bwd_chunks``.  Held here, at every norm shape of the
SD-1.x UNet's train step (found by running the full-width model on the
meta device) and of ``chip_smoke.py``'s ``norm_cases``:

* the LayerNorm grids cover every row exactly once (the backward's in
  whole clusters); the forward holds a row in registers exactly where
  16-byte vectors of at most 8, 16 or 32 lanes hold it;
* the GroupNorm plan covers every (sample, group) row exactly once and
  each row's channels exactly once, on channel boundaries; each CTA's
  chunks lie in the shared memory it asks for; the chunks are staged in
  shared memory exactly where they fit, can be copied in 16-byte units
  and the tensors are too large for the L2 to serve a second pass, and
  streamed everywhere else;
* the C declarations in ``csrc/kernels.h`` match the ctypes argument
  types the wrappers bind, and the sources' constants match the plans';
* a warm wrapper call reuses its checks and plan (a stub library counts
  the C calls).
"""

import ctypes
import importlib
import importlib.util
import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import _build

from _torch_port_util import one_thread  # noqa: F401

ln = importlib.import_module("paddle_tpu_torch.ops.layer_norm")
gn = importlib.import_module("paddle_tpu_torch.ops.group_norm")

SMS = 132   # an H100 SXM's multiprocessors


@pytest.fixture(scope="module")
def unet_norm_shapes():
    """({(x shape, groups): calls}, {LayerNorm x shape: calls}) of one
    forward of the SD-1.x UNet at chip_smoke.py's batch 4 and 64x64
    latents (the backward calls the same shapes once each), traced on
    the meta device: no weights are made and nothing is computed."""
    import paddle_tpu_torch.models.unet as U
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain

    seen_gn, seen_ln = Counter(), Counter()

    def group_norm(x, w, b, groups, eps=1e-5):
        seen_gn[(tuple(x.shape), groups)] += 1
        return gn.group_norm_plain(x, w, b, groups, eps)

    def layer_norm(x, w, b, eps=1e-5):
        seen_ln[tuple(x.shape)] += 1
        return ln.layer_norm_plain(x, w, b, eps)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "_group_norm_op", group_norm)
        mp.setattr(F, "_layer_norm_op", layer_norm)
        mp.setattr(F, "flash_attention", flash_attention_plain)
        mp.setattr(U, "resolve_device", lambda device=None: torch.device("meta"))
        mp.setattr(U.UNet2DConditionModel, "_init_weights",
                   lambda self, dev, seed: None)
        model = U.UNet2DConditionModel(U.UNetConfig(channels_last=False),
                                       dtype=torch.bfloat16)
        meta = dict(device="meta", dtype=torch.bfloat16)
        with torch.no_grad():
            model(torch.empty(4, 4, 64, 64, **meta),
                  torch.zeros(4, dtype=torch.int64, device="meta"),
                  torch.empty(4, 77, 768, **meta))
    return seen_gn, seen_ln


def test_the_unet_step_has_chip_smokes_launch_counts(unet_norm_shapes):
    """61 GroupNorms and 48 LayerNorms a step (``UNET_PER_STEP``), so the
    shapes below are the whole of the path."""
    seen_gn, seen_ln = unet_norm_shapes
    assert sum(seen_gn.values()) == 61
    assert sum(seen_ln.values()) == 48


def _gn_cases(unet_norm_shapes):
    """(n, c, groups, hw, itemsize, aligned) of the UNet step, of
    norm_cases (old and new shapes) and of a misaligned tensor."""
    cases = set()
    for (shape, groups), _ in unet_norm_shapes[0].items():
        n, c, h, w = shape
        cases.add((n, c, groups, h * w, 2, True))
    cases |= {(4, 320, 32, 4096, 4, True), (2, 6, 3, 35, 2, True),
              (1, 64, 1, 128 * 128, 4, True), (4, 960, 32, 4096, 2, False),
              (3, 12, 4, 16, 2, True), (2, 32, 8, 81, 4, True)}
    return sorted(cases)


def _ln_cases(unet_norm_shapes):
    cases = {(s[0] * s[1], s[2], 2, True) for s in unet_norm_shapes[1]}
    return sorted(cases | {(4096, 640, 4, True), (4096, 768, 2, True),
                           (4096, 100, 2, True), (4096, 640, 2, False),
                           (300, 4096, 2, True), (5, 3, 4, True),
                           (7, 320, 2, True)})


def _max_clusters(mode, s, smem):
    """A stand-in for the occupancy query: as many CTAs as fit the
    multiprocessors' shared memory, two at most."""
    return max(1, SMS * min(2, gn.SMEM_MAX // max(smem, 1)) // s)


def test_group_norm_plan_covers_every_row_and_channel_once(unet_norm_shapes):
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        for cap in (_max_clusters, lambda *a: 1, lambda *a: 7):
            plan = gn.group_norm_bwd_plan(n, c, groups, hw, item, aligned,
                                          SMS, cap)
            rows = n * groups
            walked = [r for k in range(plan["clusters"])
                      for r in gn.group_norm_bwd_rows(plan, rows, k)]
            assert sorted(walked) == list(range(rows)), (n, c, groups, plan)
            assert 1 <= plan["clusters"] <= rows
            cg = c // groups
            chunks = gn.group_norm_bwd_chunks(plan, cg)
            assert len(chunks) == plan["cluster"] <= min(gn.GN_MAX_CLUSTER,
                                                         cg)
            assert chunks[0][0] == 0 and chunks[-1][1] == cg
            assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
            assert all(c1 > c0 for c0, c1 in chunks)      # no empty CTA
            assert max(c1 - c0 for c0, c1 in chunks) == plan["max_ch"]


def test_group_norm_chunks_fit_the_shared_memory_they_ask_for(
        unet_norm_shapes):
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        plan = gn.group_norm_bwd_plan(n, c, groups, hw, item, aligned, SMS,
                                      _max_clusters)
        assert plan["smem"] == gn.group_norm_bwd_smem(
            plan["mode"], plan["max_ch"], hw, item) <= gn.SMEM_MAX
        if plan["mode"] == 0:
            chunk = plan["max_ch"] * hw * item
            assert chunk % 16 == 0                   # whole bulk copies
            assert 2 * gn.GN_STAGES * chunk < plan["smem"]
            if plan["cluster"] < min(gn.GN_MAX_CLUSTER, c // groups):
                assert 2 * chunk <= gn.CHUNK_TARGET


def test_group_norm_streams_exactly_where_staging_cannot_or_need_not_run(
        unet_norm_shapes):
    """Staged (mode 0) exactly where the chunks fit in shared memory, can
    be copied in 16-byte units, and x and g exceed STAGED_MIN_BYTES; the
    streamed variants everywhere else."""
    modes = {}
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        plan = gn.group_norm_bwd_plan(n, c, groups, hw, item, aligned, SMS,
                                      _max_clusters)
        cg = c // groups
        top = min(gn.GN_MAX_CLUSTER, cg)
        vec = aligned and hw * item % 16 == 0
        fits = gn.group_norm_bwd_smem(0, -(-cg // top), hw, item) \
            <= gn.SMEM_MAX
        big = 2 * n * c * hw * item > gn.STAGED_MIN_BYTES
        want = 0 if vec and fits and big else 1 if vec else 2
        assert plan["mode"] == want, (n, c, groups, hw, item, aligned)
        modes[(n, c, groups, hw, item, aligned)] = plan["mode"]
    # the UNet's two longest rows are staged, its other shapes streamed;
    # each reason to stream is exercised by a norm_cases shape
    assert modes[(4, 960, 32, 4096, 2, True)] == 0
    assert modes[(4, 640, 32, 4096, 2, True)] == 0
    assert modes[(4, 320, 32, 4096, 2, True)] == 1        # fits the L2
    assert modes[(1, 64, 1, 128 * 128, 4, True)] == 1     # too long a row
    assert gn.group_norm_bwd_smem(0, 8, 128 * 128, 4) > gn.SMEM_MAX
    assert modes[(2, 6, 3, 35, 2, True)] == 2             # 70-byte channels
    assert modes[(4, 960, 32, 4096, 2, False)] == 2       # misaligned


def test_group_norm_cluster_size(unet_norm_shapes):
    """Staged, the cluster size is the smallest that gives 2 * SMS CTAs
    over the rows with chunks of at most CHUNK_TARGET bytes (the
    SD-UNet's longest row splits over 8 CTAs); streamed, the smallest
    that gives SMS / 2 CTAs (one CTA a row at the UNet's 128 rows; a
    single long row splits over 8)."""
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        plan = gn.group_norm_bwd_plan(n, c, groups, hw, item, aligned, SMS,
                                      _max_clusters)
        s, cg, rows = plan["cluster"], c // groups, n * groups
        if s < min(gn.GN_MAX_CLUSTER, cg):
            want = 2 * SMS if plan["mode"] == 0 else SMS / 2
            assert rows * s >= want
            assert s == 1 or rows * (s - 1) < want or (
                plan["mode"] == 0 and 2 * -(-cg // (s - 1)) * hw * item
                > gn.CHUNK_TARGET)
    plan = gn.group_norm_bwd_plan(4, 960, 32, 4096, 2, True, SMS,
                                  _max_clusters)
    assert (plan["mode"], plan["cluster"], plan["max_ch"]) == (0, 8, 4)
    plan = gn.group_norm_bwd_plan(1, 64, 1, 128 * 128, 4, True, SMS,
                                  _max_clusters)
    assert (plan["mode"], plan["cluster"]) == (1, 8)
    for (shape, groups) in unet_norm_shapes[0]:
        n, c, h, w = shape
        plan = gn.group_norm_bwd_plan(n, c, groups, h * w, 2, True, SMS,
                                      _max_clusters)
        if plan["mode"]:
            assert plan["cluster"] == 1


def test_group_norm_fwd_plan_covers_every_row_and_channel_once(
        unet_norm_shapes):
    """The forward's grid is N * G clusters of S CTAs, CTA i taking rank i
    % S of row i // S: every (sample, group) row once, and its ranks
    every channel once, on channel boundaries, none empty."""
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        plan = gn.group_norm_fwd_plan(n, c, groups, hw, item, aligned)
        s, cg, rows = plan["cluster"], c // groups, n * groups
        assert plan["ctas"] == rows * s
        assert 1 <= s <= min(gn.GN_MAX_CLUSTER, cg)
        walked = Counter(i // s for i in range(plan["ctas"]))
        assert walked == Counter({r: s for r in range(rows)})
        chunks = gn.group_norm_fwd_chunks(plan, cg)
        assert len(chunks) == s
        assert chunks[0][0] == 0 and chunks[-1][1] == cg
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(c1 > c0 for c0, c1 in chunks)
        assert max(c1 - c0 for c0, c1 in chunks) == plan["max_ch"]


def test_group_norm_fwd_chunks_fit_the_shared_memory_they_ask_for(
        unet_norm_shapes):
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        plan = gn.group_norm_fwd_plan(n, c, groups, hw, item, aligned)
        assert plan["smem"] == gn.group_norm_fwd_smem(
            plan["mode"], plan["max_ch"], hw, item) <= gn.SMEM_MAX
        chunk = plan["max_ch"] * hw * item
        if plan["mode"] == 0:
            assert chunk % 16 == 0                   # whole bulk copies
            pieces = -(-chunk // gn.GNF_PIECE)
            assert chunk + 8 * pieces < plan["smem"]
        else:                                        # no chunk staged
            assert plan["smem"] == gn.group_norm_fwd_smem(1, plan["max_ch"],
                                                          1, 1)
        if 1 < plan["cluster"] < min(gn.GN_MAX_CLUSTER, c // groups):
            assert chunk <= gn.FWD_CHUNK_TARGET


def test_group_norm_fwd_scalars_exactly_where_vectors_cannot_run(
        unet_norm_shapes):
    """Mode 2 (scalars) exactly where the rows' channels are not whole
    16-byte vectors or the tensors not 16-byte aligned; otherwise staged
    (mode 0) exactly where the row exceeds FWD_STREAM_MAX bytes and the
    chunk fits shared memory, streamed vectors (mode 1) elsewhere."""
    modes = {}
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        plan = gn.group_norm_fwd_plan(n, c, groups, hw, item, aligned)
        vec = aligned and hw * item % 16 == 0
        row = c // groups * hw * item
        fits = gn.group_norm_fwd_smem(0, plan["max_ch"], hw, item) \
            <= gn.SMEM_MAX
        want = 2 if not vec else 0 if row > gn.FWD_STREAM_MAX and fits \
            else 1
        assert plan["mode"] == want, (n, c, groups, hw, item, aligned)
        modes[(n, c, groups, hw, item, aligned)] = plan["mode"]
    assert modes[(2, 6, 3, 35, 2, True)] == 2             # 70-byte channels
    assert modes[(4, 960, 32, 4096, 2, False)] == 2       # misaligned
    assert modes[(2, 32, 8, 81, 4, True)] == 2            # 324-byte channels
    assert modes[(1, 64, 1, 128 * 128, 4, True)] == 1     # too long a chunk
    assert modes[(4, 1280, 32, 64, 2, True)] == 1         # a 5 KB row
    assert modes[(4, 640, 32, 1024, 2, True)] == 1        # a 40 KB row
    assert modes[(4, 960, 32, 1024, 2, True)] == 0        # a 60 KB row
    assert modes[(4, 960, 32, 4096, 2, True)] == 0


def test_group_norm_fwd_holds_a_streamed_row_in_registers(
        unet_norm_shapes):
    """A streamed row of at most FWD_STREAM_MAX bytes fits the smallest
    hold the plan gives it (a CTA's 256 threads hold it in registers),
    and no smaller hold would; a chunk too long for that streams with
    the largest hold; staged and scalar launches hold 1 and 4."""
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        plan = gn.group_norm_fwd_plan(n, c, groups, hw, item, aligned)
        k, nv = plan["hold"], plan["max_ch"] * hw * item // 16
        if plan["mode"] != 1:
            assert k == (1 if plan["mode"] == 0 else 4)
        elif nv <= gn.FWD_HOLDS[-1] * gn.GNF_WARPS * 32:
            assert nv <= k * gn.GNF_WARPS * 32
            smaller = [h for h in gn.FWD_HOLDS if h < k]
            assert not smaller or nv > smaller[-1] * gn.GNF_WARPS * 32
        else:
            assert k == gn.FWD_HOLDS[-1]
    hold = {s: gn.group_norm_fwd_plan(s[0], s[1], 32, s[2] * s[3], 2,
                                      True)["hold"]
            for s in [(4, 1280, 8, 8), (4, 2560, 8, 8), (4, 1280, 16, 16),
                      (4, 640, 32, 32)]}
    assert list(hold.values()) == [4, 4, 8, 10]


def test_group_norm_fwd_cluster_size(unet_norm_shapes):
    """A row of at most FWD_ROW_MAX bytes is one CTA's; a longer one
    takes the smallest S that gives chunks of at most FWD_CHUNK_TARGET
    bytes (the SD-UNet's two longest rows over 8 and 5 CTAs)."""
    for n, c, groups, hw, item, aligned in _gn_cases(unet_norm_shapes):
        plan = gn.group_norm_fwd_plan(n, c, groups, hw, item, aligned)
        s, cg = plan["cluster"], c // groups
        if cg * hw * item <= gn.FWD_ROW_MAX:
            assert s == 1
        elif s < min(gn.GN_MAX_CLUSTER, cg):
            assert plan["max_ch"] * hw * item <= gn.FWD_CHUNK_TARGET
            assert s == 2 or -(-cg // (s - 1)) * hw * item \
                > gn.FWD_CHUNK_TARGET
    big = {(shape, groups): gn.group_norm_fwd_plan(
        shape[0], shape[1], groups, shape[2] * shape[3], 2, True)["cluster"]
        for shape, groups in unet_norm_shapes[0]}
    assert big.pop(((4, 960, 64, 64), 32)) == 8
    assert big.pop(((4, 640, 64, 64), 32)) == 5
    assert set(big.values()) == {1}


def test_chip_smokes_sweep_shapes_are_the_unet_steps(unet_norm_shapes):
    """chip_smoke.py's forward sweep (UNET_GN_SHAPES) holds every
    GroupNorm shape of the step with its number of calls."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {(shape, 32): k for shape, k in smoke.UNET_GN_SHAPES.items()} \
        == dict(unet_norm_shapes[0])


def test_layer_norm_grid_covers_every_row_once(unet_norm_shapes):
    for n, h, item, aligned in _ln_cases(unet_norm_shapes):
        for cap in (8, 64, 120, 240, 496):
            plan = ln.layer_norm_bwd_plan(n, h, item, aligned,
                                          lambda k: cap)
            ctas = plan["ctas"]
            assert ctas % ln.LN_CLUSTER == 0 and 0 < ctas <= cap
            walked = [r for cta in range(ctas) for w in range(ln.LN_WARPS)
                      for r in ln.layer_norm_bwd_rows(plan, n, cta, w)]
            assert sorted(walked) == list(range(n)), (n, h, cap, plan)
            per = [len(ln.layer_norm_bwd_rows(plan, n, cta, w))
                   for cta in range(ctas) for w in range(ln.LN_WARPS)]
            # the busiest warp takes as few rows as the cap allows
            unit = ln.LN_WARPS if plan["k"] else 1
            assert max(per) == -(-n // (unit * cap))
            clusters = ctas // ln.LN_CLUSTER
            assert plan["ws"] == (clusters + (0 if plan["k"] else ctas)) \
                * 2 * h


@pytest.mark.parametrize("h,item,aligned,k", [
    (320, 2, True, 2), (640, 2, True, 3), (1280, 2, True, 5),
    (768, 2, True, 3), (1536, 2, True, 6), (1544, 2, True, 0),
    (640, 4, True, 5), (768, 4, True, 6), (1024, 4, True, 0),
    (100, 2, True, 0), (3, 4, True, 0), (640, 2, False, 0)])
def test_layer_norm_rows_in_registers_up_to_six_vectors_a_lane(h, item,
                                                                aligned, k):
    """The warp-per-row kernel holds a row in whole 16-byte vectors, at
    most LN_KMAX a lane; the rest take the CTA-per-row kernel."""
    assert ln.layer_norm_bwd_chunks(h, item, aligned) == k


@pytest.mark.parametrize("cap", [8, 64, 120, 240, 496])
def test_layer_norm_fwd_grid_covers_every_row_once(unet_norm_shapes, cap):
    """Every row once: a CTA a row where a row is a CTA's; else at most
    the occupancy cap's CTAs, the busiest warp taking as few groups of
    rows as the cap allows."""
    for n, h, item, aligned in _ln_cases(unet_norm_shapes):
        plan = ln.layer_norm_fwd_plan(n, h, item, aligned,
                                      lambda k, t, w: cap)
        ctas, threads = plan["ctas"], plan["threads"]
        in_warp = 0 < threads <= 32          # rows of a warp or less
        assert plan["warps"] == (ln.LN_WARPS if in_warp or not plan["k"]
                                 else threads // 32)
        walked = [r for cta in range(ctas) for w in range(plan["warps"])
                  for r in ln.layer_norm_fwd_rows(plan, n, cta, w)]
        assert sorted(walked) == list(range(n)), (n, h, cap, plan)
        if not in_warp:                      # a CTA a row
            assert ctas == n
            continue
        assert 0 < ctas <= cap
        rpw = 32 // threads                  # rows a group
        groups = [-(-len(ln.layer_norm_fwd_rows(plan, n, cta, w)) // rpw)
                  for cta in range(ctas) for w in range(plan["warps"])]
        assert max(groups) == -(-n // (plan["warps"] * rpw * cap))


@pytest.mark.parametrize("h,item,aligned,layout", [
    (320, 2, True, (3, 16)), (640, 2, True, (3, 32)),
    (1280, 2, True, (1, 160)), (768, 2, True, (3, 32)),
    (1536, 2, True, (3, 64)), (6144, 2, True, (3, 256)),
    (6152, 2, True, (0, 0)), (640, 4, True, (5, 32)),
    (768, 4, True, (6, 32)), (1024, 4, True, (4, 64)), (64, 2, True, (1, 8)),
    (100, 2, True, (0, 0)), (3, 4, True, (0, 0)), (640, 2, False, (0, 0))])
def test_layer_norm_fwd_rows_in_registers_where_vectors_hold_them(
        h, item, aligned, layout):
    """The forward holds a row in whole 16-byte vectors, at most LNF_VALUES
    values a thread, over the thread count of LNF_THREADS that leaves the
    fewest slots empty (the fewest threads among equals): the SD UNet's
    H 320 and 640 in 16 and 32 lanes of a warp, its H 1280 in a CTA of 5
    warps.  The rest take the CTA-per-row kernel."""
    assert ln.layer_norm_fwd_layout(h, item, aligned) == layout
    vw = 16 // item
    fits = [(-(-h // (vw * t)), t) for t in ln.LNF_THREADS
            if -(-h // (vw * t)) * vw <= ln.LNF_VALUES]
    if layout != (0, 0):
        k, threads = layout
        assert k * vw <= ln.LNF_VALUES and h <= k * threads * vw
        assert min((k_ * t, t) for k_, t in fits) == (k * threads, threads)
    else:
        assert not (aligned and h % vw == 0 and fits)


def test_chip_smokes_ln_sweep_shapes_are_the_unet_steps(unet_norm_shapes):
    """chip_smoke.py's LayerNorm forward sweep (UNET_LN_SHAPES) holds every
    LayerNorm shape of the step, as [rows, H], with its number of calls."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rows = Counter()
    for shape, k in unet_norm_shapes[1].items():
        rows[(shape[0] * shape[1], shape[2])] += k
    assert smoke.UNET_LN_SHAPES == dict(rows)


def _declarations():
    """{C function: [(type, name), ...]} of csrc/kernels.h."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "kernels.h").read_text())
    out = {}
    for name, params in re.findall(r"int\s+(\w+)\s*\(([^)]*)\)\s*;", text):
        args = []
        for p in params.split(","):
            m = re.match(r"\s*(.*?)\s*(\w+)\s*$", p.replace("\n", " "))
            args.append((m.group(1).replace(" *", "*"), m.group(2)))
        out[name] = args
    return out


def _matches(ctype, decl_type, name):
    if decl_type.endswith("*"):
        if name in ("ctas", "clusters"):          # the queries' out-params
            return ctype is ctypes.POINTER(ctypes.c_int)
        return ctype is ctypes.c_void_p
    return ctype is {"int": ctypes.c_int, "float": ctypes.c_float}[decl_type]


@pytest.mark.parametrize("module", [ln, gn], ids=["layer_norm", "group_norm"])
def test_kernels_h_declarations_match_the_ctypes_argtypes(module):
    decls = _declarations()
    for fn, types in module.ARGTYPES.items():
        params = decls[fn]
        assert len(params) == len(types), fn
        for t, (decl, name) in zip(types, params):
            assert _matches(t, decl, name), (fn, name, decl, t)


def test_norm_sources_agree_with_the_plans():
    """The constants and the kernel table of norms.cu are the plans'."""
    text = (_build.CSRC / "norms.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(const["LN_WARPS"]) == ln.LN_WARPS
    assert int(const["LN_CLUSTER"]) == ln.LN_CLUSTER
    assert int(const["GN_WARPS"]) == gn.GN_WARPS
    assert int(const["GN_MAX_CLUSTER"]) == gn.GN_MAX_CLUSTER
    assert int(const["GN_STAGES"]) == gn.GN_STAGES
    assert int(const["GNF_WARPS"]) == gn.GNF_WARPS
    assert int(const["GNF_PIECE"]) == gn.GNF_PIECE
    # the streamed forward's instantiations are the plan's holds
    holds = [int(k) for k in re.findall(
        r"mode == 1 && hold == (\d+)\) return gn_fwd_kernel<T, 1, \1>;", text)]
    assert tuple(holds) == gn.FWD_HOLDS
    # the forward's shared memory: chunk, a barrier a piece, the exchange's
    # barrier and slots, the weights and biases (group_norm_fwd_smem)
    assert ("chunk + 8 * ((chunk + GNF_PIECE - 1) / GNF_PIECE + 1 + "
            "GN_MAX_CLUSTER + (size_t)max_ch)") in text
    ks = {int(k) for k in re.findall(
        r"case (\d+): return ln_bwd_warp_kernel<T, \1>;", text)}
    assert ks == set(range(1, ln.LN_KMAX + 1))
    # the LayerNorm forward's instantiations: k vectors of at most
    # LNF_VALUES values (k <= 3 in 2-byte types, 6 in f32), each for rows of
    # 8, 16 and 32 lanes and of a CTA (LNF_THREADS)
    assert int(const["LNF_VALUES"]) == ln.LNF_VALUES
    ks = [int(k) for k in re.findall(
        r"case (\d+): return ln_fwd_kernel_k<T, \1, SAME>\(threads\);",
        text)]
    assert ks == list(range(1, ln.LNF_VALUES // 4 + 1))
    assert text.index("if constexpr (6 * (16 / sizeof(T)) <= LNF_VALUES)") \
        < text.index("case 4: return ln_fwd_kernel_k<T, 4, SAME>(threads);")
    lanes = [int(m) for m in re.findall(
        r"if \(threads == (\d+)\) return ln_fwd_warp_kernel<T, K, \1, "
        r"SAME>;", text)]
    assert tuple(lanes) == tuple(t for t in ln.LNF_THREADS if t <= 32)
    assert "return ln_fwd_cta_kernel<T, K, SAME>;" in text
    for fn in list(ln.ARGTYPES) + list(gn.ARGTYPES):
        assert f'extern "C" int {fn}(' in text


def test_kernel_wrappers_take_only_cuda_tensors():
    """On CPU tensors the kernel wrappers raise: the CPU runs the plain
    twins through the dispatchers, and nothing launches or falls back."""
    x = torch.randn(4, 8)
    w = torch.ones(8)
    stats = torch.zeros(4)
    with pytest.raises(ValueError):
        ln.layer_norm_bwd_kernel(x, w, stats, stats, x)
    with pytest.raises(ValueError):
        ln.layer_norm_kernel(x, w, w)
    x4 = torch.randn(2, 8, 3, 3)
    with pytest.raises(ValueError):
        gn.group_norm_bwd_kernel(x4, w, stats, stats, x4, 2)
    with pytest.raises(ValueError):
        gn.group_norm_kernel(x4, w, w, 2)


class _StubFn:
    """A C entry point of the stub library: records each call's
    arguments, sets an out-parameter to 4, returns 0."""

    argtypes = None

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, *args):
        self.calls.append(args)
        if isinstance(args[-1], type(ctypes.byref(ctypes.c_int()))):
            args[-1]._obj.value = 4
        return 0


@pytest.fixture
def stub_library(monkeypatch):
    """The GroupNorm wrappers on CPU tensors against a stub of the CUDA
    library: the checks that need a card pass, the stream is 7, every
    device is the current one, and a device-properties read counts.
    Yields {"load": [...], "props": [...], C function: [calls]}."""
    seen = {"load": [], "props": [], "group_norm_fwd": [],
            "group_norm_bwd": [], "group_norm_bwd_max_clusters": []}
    lib = type("Lib", (), {k: _StubFn(seen[k]) for k in gn.ARGTYPES})
    monkeypatch.setattr(gn._build, "load",
                        lambda name: seen["load"].append(name) or lib)
    monkeypatch.setattr(gn._build, "_TICKETS", {})
    monkeypatch.setattr(gn, "_check", lambda name, x, w, groups, *rest:
                        gn._dims(x, groups))
    monkeypatch.setattr(gn, "_stream", lambda index: 7)
    monkeypatch.setattr(gn, "_FWD_LAUNCHES", {})
    monkeypatch.setattr(gn, "_BWD_LAUNCHES", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties", lambda d: seen["props"].append(
            d) or type("P", (), {"multi_processor_count": SMS}))
    for fn in (gn.group_norm, gn.group_norm_bwd):
        monkeypatch.setattr(fn, "launches", fn.launches)
    yield seen


def test_a_warm_forward_call_reuses_its_plan(stub_library, monkeypatch):
    """The forward's checks, plan and library lookup run once per (device,
    dtypes, shapes, alignment); each call launches once with the plan's
    constants, the eps it was given and the current stream."""
    seen = stub_library
    plans = []
    plan_of = gn.group_norm_fwd_plan
    monkeypatch.setattr(gn, "group_norm_fwd_plan",
                        lambda *a: plans.append(a) or plan_of(*a))
    x = torch.randn(4, 64, 8, 8)
    w, b = torch.ones(64), torch.zeros(64, dtype=torch.bfloat16)
    launches = gn.group_norm.launches
    for eps in (1e-5, 1e-6, 1e-5):
        y, mean, rstd = gn.group_norm_kernel(x, w, b, 32, eps)
    assert y.shape == x.shape and mean.shape == rstd.shape == (128,)
    assert len(plans) == 1 and seen["load"] == ["norms"]
    assert seen["props"] == []
    calls = seen["group_norm_fwd"]
    assert len(calls) == 3 == gn.group_norm.launches - launches
    plan = plan_of(4, 64, 32, 64, 4, x.data_ptr() % 16 == 0)
    assert calls[0][5:16] == (4, 64, 32, 64, 0, 0, 1, plan["mode"],
                              plan["hold"], plan["cluster"], plan["smem"])
    assert [c[16:] for c in calls] == [(1e-5, 7), (1e-6, 7), (1e-5, 7)]
    gn.group_norm_kernel(x[:2].contiguous(), w, b, 32)     # another shape
    assert len(plans) == 2 and len(calls) == 4


def test_a_warm_backward_call_reuses_its_plan(stub_library):
    """The backward's plan (its occupancy queries and the device's
    multiprocessors) is made once per key, as the forward's."""
    seen = stub_library
    x, g = torch.randn(4, 64, 8, 8), torch.randn(4, 64, 8, 8)
    w, stats = torch.ones(64), torch.zeros(128)
    launches = gn.group_norm_bwd.launches
    for _ in range(3):
        gn.group_norm_bwd_kernel(x, w, stats, stats, g, 32)
    assert len(seen["props"]) == 1 and seen["load"] == ["norms"]
    queries = len(seen["group_norm_bwd_max_clusters"])
    assert queries >= 1
    calls = seen["group_norm_bwd"]
    assert len(calls) == 3 == gn.group_norm_bwd.launches - launches
    assert len({c[10:] for c in calls}) == 1 and calls[0][-1] == 7
    gn.group_norm_bwd_kernel(x, w, stats, stats, g, 32)
    assert len(seen["props"]) == 1
    assert len(seen["group_norm_bwd_max_clusters"]) == queries


@pytest.fixture
def ln_stub_library(monkeypatch):
    """The LayerNorm wrappers on CPU tensors against a stub of the CUDA
    library, as ``stub_library`` for GroupNorm.  Yields {"load": [...],
    C function: [calls]}."""
    seen = {"load": [], **{k: [] for k in ln.ARGTYPES}}
    lib = type("Lib", (), {k: _StubFn(seen[k]) for k in ln.ARGTYPES})
    monkeypatch.setattr(ln._build, "load",
                        lambda name: seen["load"].append(name) or lib)
    monkeypatch.setattr(ln._build, "_TICKETS", {})
    monkeypatch.setattr(ln, "_check", lambda name, x, w, *rest: x.shape[-1])
    monkeypatch.setattr(ln, "_stream", lambda index: 7)
    monkeypatch.setattr(ln, "_FWD_LAUNCHES", {})
    monkeypatch.setattr(ln, "_BWD_LAUNCHES", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    for fn in (ln.layer_norm, ln.layer_norm_bwd):
        monkeypatch.setattr(fn, "launches", fn.launches)
    yield seen


def test_a_warm_layer_norm_forward_call_reuses_its_plan(ln_stub_library,
                                                        monkeypatch):
    """The LayerNorm forward's checks, plan (with its occupancy query)
    and library lookup run once per key; each call launches once with the
    plan's constants, the eps it was given and the current stream."""
    seen = ln_stub_library
    plans = []
    plan_of = ln.layer_norm_fwd_plan
    monkeypatch.setattr(ln, "layer_norm_fwd_plan",
                        lambda *a: plans.append(a) or plan_of(*a))
    x = torch.randn(4, 16, 320, dtype=torch.bfloat16)
    w = torch.ones(320, dtype=torch.bfloat16)
    b = torch.zeros(320)
    launches = ln.layer_norm.launches
    for eps in (1e-5, 1e-6, 1e-5):
        y, mean, rstd = ln.layer_norm_kernel(x, w, b, eps)
    assert y.shape == x.shape and mean.shape == rstd.shape == (64,)
    assert len(plans) == 1 and seen["load"] == ["norms"]
    assert len(seen["layer_norm_fwd_max_ctas"]) == 1
    calls = seen["layer_norm_fwd"]
    assert len(calls) == 3 == ln.layer_norm.launches - launches
    aligned = (x.data_ptr() | w.data_ptr() | b.data_ptr()) % 16 == 0
    plan = plan_of(64, 320, 2, aligned, lambda *a: 4)
    assert seen["layer_norm_fwd_max_ctas"][0][:3] == (1, 1, 0)
    assert calls[0][5:14] == (64, 320, 1, 1, 0, plan["k"], plan["threads"],
                              plan["warps"], plan["ctas"])
    assert [c[14:] for c in calls] == [(1e-5, 7), (1e-6, 7), (1e-5, 7)]
    ln.layer_norm_kernel(x[:2].contiguous(), w, b)          # another shape
    assert len(plans) == 2 and len(calls) == 4


def test_a_warm_layer_norm_backward_call_reuses_its_plan(ln_stub_library):
    """The LayerNorm backward's plan (its occupancy queries) is made once
    per key, as the forward's."""
    seen = ln_stub_library
    x, g = torch.randn(64, 320), torch.randn(64, 320)
    w, stats = torch.ones(320), torch.zeros(64)
    launches = ln.layer_norm_bwd.launches
    for _ in range(3):
        ln.layer_norm_bwd_kernel(x, w, stats, stats, g)
    assert seen["load"] == ["norms"]
    queries = len(seen["layer_norm_bwd_max_ctas"])
    assert queries >= 1
    calls = seen["layer_norm_bwd"]
    assert len(calls) == 3 == ln.layer_norm_bwd.launches - launches
    assert len({(c[9],) + c[11:] for c in calls}) == 1 and calls[0][-1] == 7
    ln.layer_norm_bwd_kernel(x, w, stats, stats, g)
    assert len(seen["layer_norm_bwd_max_ctas"]) == queries
