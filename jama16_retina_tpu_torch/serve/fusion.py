"""Cross-engine batch fusion (counterpart of
``jama16_retina_tpu/serve/fusion.py``): one dispatch for rows bound to
different models.

With ``serve.router_fusion`` the router's dispatch tick may cut bins that
mix models, and ``score_mixed`` scores them:

  * fused, when every engine in the bin has the same ``fusion_token``
    (the same program: model, member form, TTA, serving dtype, device and
    preprocess): each model's generation handle is pinned once, in sorted
    model order; the bin is padded to its bucket and normalized by one
    ``fused_serve_preprocess`` (kernel B4) on the fused path; every
    member of every model forwards over the whole normalized bin, through
    one ``torch.func.vmap`` over the concatenated stacked members under
    ``serve.member_parallel``, else through the concatenated member lists
    in turn (no copy); each model's rows are its members' rows averaged
    by ``metrics.ensemble_average``, through the index sets the mux used;
  * grouped otherwise (stubs, cascades, programs that differ): one
    ``probs_with_generation`` (or ``probs``) call per model on its rows,
    scattered back by index.

Every row keeps its place and is attributed to its model's generation.
The fused path bypasses ``probs_with_generation``, so ``_observe_fused``
replays its hooks on each model's slice: the pinned generation's row
counter (``serve.gen{N}.rows``), the shadow sampler, the quality monitor
(fed the slice's B4 statistics, so a tenant's drift windows are the same
fused or not) and the canary, on the pinned generation.

A fused bin runs at the bin's bucket, not each tenant's: a tenant's rows
can run at a larger shape than its own call would use, so bitwise
equality with a tenant's direct rows holds at one bucket.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from jama16_retina_tpu_torch.eval import metrics
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.serve import host


def _model_fingerprint(cfg, device_type: str) -> dict:
    """Copy of the reference's ``compilecache.model_fingerprint`` for one
    device and no mesh, torch's version and the device type in place of
    jax's and the backend."""
    m = cfg.model
    return {
        "arch": m.arch,
        "head": m.head,
        "image_size": int(m.image_size),
        "compute_dtype": m.compute_dtype,
        "aux_head": bool(m.aux_head),
        "stem_s2d": bool(m.stem_s2d),
        "member_parallel": bool(cfg.serve.member_parallel),
        "tta": bool(cfg.eval.tta),
        "n_devices": 1,
        "mesh_axes": "none",
        "process_count": 1,
        "torch": torch.__version__,
        "device": device_type,
    }


def fusion_token(engine) -> "tuple | None":
    """The identity under which two engines may share one forward: the
    model fingerprint, the serving dtype (int8 dequantizes inside the
    forward) and the preprocess (B4 or the plain normalize; the JAX
    engine normalizes inside its program, the port's engine before its
    forward). None: this engine cannot fuse (a stub or a cascade)."""
    if not (hasattr(engine, "score_padded") and hasattr(engine, "_gen")
            and hasattr(engine, "cfg")):
        return None
    fp = _model_fingerprint(engine.cfg, engine.device.type)
    fp["serve_dtype"] = str(getattr(engine, "dtype", "fp32"))
    fp["fused_preprocess"] = bool(engine.fused)
    return tuple(sorted(fp.items()))


def _concat_stacked(dicts: list) -> dict:
    """Stacked member dicts (``quantize.stack`` form) concatenated on the
    member dim, Q8 values and scales each."""
    from jama16_retina_tpu_torch.serve.quantize import Q8

    out = {}
    for k, first in dicts[0].items():
        if isinstance(first, Q8):
            out[k] = Q8(q=torch.cat([d[k].q for d in dicts]),
                        s=torch.cat([d[k].s for d in dicts]))
        else:
            out[k] = torch.cat([d[k] for d in dicts])
    return out


def _fuse_generations(gens: list):
    """One ``_Generation`` holding every member of ``gens`` in order: the
    module and member lists concatenated (the same tensors), the stacked
    form concatenated on the member dim (a device copy)."""
    from jama16_retina_tpu_torch.serve.engine import _Generation

    g0 = gens[0]
    modules = (None if g0.modules is None
               else [m for g in gens for m in g.modules])
    members = (None if g0.members is None
               else [m for g in gens for m in g.members])
    stacked = None
    if g0.stacked is not None:
        stacked = (_concat_stacked([g.stacked[0] for g in gens]),
                   _concat_stacked([g.stacked[1] for g in gens]))
    return _Generation(-1, members, modules, stacked,
                       sum(g.n_members for g in gens), None)


class FusionCache:
    """The fused generation of the live combination, keyed by the exact
    (model, engine identity, generation id) tuple: a reload on any fused
    engine misses and rebuilds, so a fused forward never scores a
    retired generation. One entry: fused serving churns generations, not
    combinations.

    One router shares one cache across its replica workers, and
    ``score_mixed`` runs outside the router's lock, so the key and state
    are read and swapped under the cache's own lock, and a caller gets
    the state built or found for its own key, never one a concurrent bin
    of another key swapped in between."""

    def __init__(self):
        self._lock = threading.Lock()
        self._key = None
        self._state = None

    def fused_state(self, pinned: "list[tuple[str, object, object]]"):
        """``pinned``: [(model, engine, generation), ...]. Returns the
        fused generation and the per-model member spans [(model, k_lo,
        k_hi), ...]."""
        key = tuple((m, id(e), int(g.gen_id)) for m, e, g in pinned)
        spans = []
        k = 0
        for m, _e, g in pinned:
            spans.append((m, k, k + int(g.n_members)))
            k += int(g.n_members)
        # Build under the lock: two racing misses would otherwise both pay
        # the stacked form's device copy.
        with self._lock:
            if key == self._key:
                return self._state, spans
            state = _fuse_generations([g for _m, _e, g in pinned])
            self._state = state
            self._key = key
        return state, spans


def _model_spans(parts) -> "list[tuple[str, int, int]]":
    """Bin-row spans per part, in bin order: the mux layout the router's
    ``_make_bin_locked`` produced, reused for the demux."""
    spans = []
    lo = 0
    for req, req_lo, req_hi in parts:
        hi = lo + (req_hi - req_lo)
        spans.append((req.model, lo, hi))
        lo = hi
    return spans


def _rows_of(spans, model: str) -> np.ndarray:
    return np.concatenate([
        np.arange(lo, hi) for sm, lo, hi in spans if sm == model
    ])


def score_mixed(
    engines_by_model: dict,
    rows: np.ndarray,
    parts,
    bucket: int,
    cache: "FusionCache | None" = None,
) -> "tuple[np.ndarray, dict]":
    """Score one bin that may mix models: ``(out [n, ...], {model:
    generation})``, row i scored by the engine of row i's model. Fused
    when every engine's token agrees, grouped otherwise."""
    spans = _model_spans(parts)
    models = []
    for m, _lo, _hi in spans:
        if m not in models:
            models.append(m)

    tokens = {m: fusion_token(engines_by_model[m]) for m in models}
    if (len(models) > 1
            and all(t is not None for t in tokens.values())
            and len(set(tokens.values())) == 1):
        return _score_fused(engines_by_model, rows, spans, models,
                            bucket, cache)
    return _score_grouped(engines_by_model, rows, spans, models)


def _score_fused(engines_by_model, rows, spans, models, bucket, cache):
    # Each generation handle is pinned once, before any device work, so a
    # concurrent reload swaps the next bin's state, never this one's.
    # Sorted, not bin order: the member axis must not depend on which
    # tenant's request led the bin, or a-led and b-led bins would rebuild
    # the one-entry cache every time.
    pinned = [(m, engines_by_model[m], engines_by_model[m]._gen)
              for m in sorted(models)]
    if cache is None:
        cache = FusionCache()
    fused, member_spans = cache.fused_state(pinned)
    lead = pinned[0][1]
    n = int(rows.shape[0])
    with torch.inference_mode():
        member, sums = lead.score_padded(rows, int(bucket), fused)
        member = member.cpu().numpy()
        if sums is not None:
            sums = sums.cpu()

    out = None
    model_idx = {}
    for m, k_lo, k_hi in member_spans:
        avg = metrics.ensemble_average(list(member[k_lo:k_hi]))
        if out is None:
            out = np.empty((n, *avg.shape[1:]), avg.dtype)
        idx = _rows_of(spans, m)
        out[idx] = avg[idx]
        model_idx[m] = idx
    size = lead.cfg.model.image_size
    for m, eng, gen in pinned:
        idx = model_idx[m]
        stats = None
        if sums is not None:
            stats = serve_preprocess.input_stats_dict(
                serve_preprocess.stats_from_sums(sums[idx], size * size))
        _observe_fused(eng, gen, rows[idx], out[idx], stats)
    gens = {m: int(g.gen_id) for m, _e, g in pinned}
    return out, gens


def _observe_fused(engine, gen, images, scores, stats) -> None:
    """The hooks ``probs_with_generation`` would have fed, on one model's
    slice of a fused bin: the pinned generation's row counter,
    ``last_input_stats``, the shadow sampler, the quality monitor with the
    slice's B4 statistics, and the canary, scored on the same pinned
    generation (so canary traffic never enters the drift windows and
    never spans a concurrent reload)."""
    c_rows = getattr(gen, "c_rows", None)
    if c_rows is not None:
        c_rows.inc(int(images.shape[0]))
    if stats is not None:
        engine.last_input_stats = stats
    sh = getattr(engine, "_shadow", None)
    if sh is not None and sh.claim():
        engine._shadow_sample(sh, images, scores)
    q = getattr(engine, "quality", None)
    if q is not None:
        host.observe_with_stats(q, images, scores, stats, engine.registry)
        if q.canary_claim():
            q.run_canary(
                lambda imgs: metrics.ensemble_average(
                    list(engine.member_probs(imgs, _gen=gen))
                )
            )


def _score_grouped(engines_by_model, rows, spans, models):
    out = None
    gens = {}
    for m in models:
        idx = _rows_of(spans, m)
        eng = engines_by_model[m]
        if hasattr(eng, "probs_with_generation"):
            res, gen = eng.probs_with_generation(rows[idx])
        else:
            res = eng.probs(rows[idx])
            gen = int(getattr(eng, "generation", 0))
        res = np.asarray(res)
        if out is None:
            out = np.empty(
                (int(rows.shape[0]), *res.shape[1:]), res.dtype
            )
        out[idx] = res
        gens[m] = int(gen)
    return out, gens
