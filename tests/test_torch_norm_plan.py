"""The launch plans of the CUDA LayerNorm and GroupNorm backwards
(``csrc/norms.cu``), read on the CPU (no nvcc, no card).  The plans are
pure Python in ``ops/layer_norm.py`` and ``ops/group_norm.py``: the
kernels take the grid, the cluster size, the mode and the shared memory
from them, and walk rows and channels by the same formulas as
``layer_norm_bwd_rows``, ``group_norm_bwd_rows`` and
``group_norm_bwd_chunks``.  Held here, at every norm shape of the SD-1.x
UNet's train step (found by running the full-width model on the meta
device) and of ``chip_smoke.py``'s ``norm_cases``:

* the LayerNorm grid covers every row exactly once, in whole clusters;
* the GroupNorm plan covers every (sample, group) row exactly once and
  each row's channels exactly once, on channel boundaries; each CTA's
  chunks lie in the shared memory it asks for; the chunks are staged in
  shared memory exactly where they fit, can be copied in 16-byte units
  and the tensors are too large for the L2 to serve a second pass, and
  streamed everywhere else;
* the C declarations in ``csrc/kernels.h`` match the ctypes argument
  types the wrappers bind, and the sources' constants match the plans'.
"""

import ctypes
import importlib
import re
from collections import Counter

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
    ks = {int(k) for k in re.findall(
        r"case (\d+): return ln_bwd_warp_kernel<T, \1>;", text)}
    assert ks == set(range(1, ln.LN_KMAX + 1))
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
    x4 = torch.randn(2, 8, 3, 3)
    with pytest.raises(ValueError):
        gn.group_norm_bwd_kernel(x4, w, stats, stats, x4, 2)
