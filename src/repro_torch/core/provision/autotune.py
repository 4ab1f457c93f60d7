"""Kernel autotuner on Hopper: the port of ``repro/core/provision/autotune.py``.

The reference tunes the block sizes of its four Pallas kernels for the
TPU's 128x128 matrix unit. The port's four hand-written CUDA kernels have
other knobs, one each, and this module searches them with the reference's
deterministic hillclimb, seeded from what the main path launches today:

- ``flash_attention`` (bf16): ``group``, the (b, h) pairs a CTA group
  shares the L2 cache with (it orders the CTAs; the output's bits do not
  change);
- ``decode_attention``: ``split``, the cache positions a CTA;
- ``rwkv6`` (bf16): ``value_tile``, the value columns a CTA;
- ``mamba2_ssd`` (bf16): ``state_tile``, the state columns a CTA.

The winners go to a tuning cache with the reference's JSON layout and keys
(``BENCH_kernels.json``: best config and the fraction of the roofline
ceiling it reaches per (kernel, shape, family)); the shape dicts carry
``"dtype"`` as well. No model, serving or training path reads the cache,
as in the reference: the wrappers launch their own rule unless a caller
passes a knob, and only this module does.

Determinism: candidate measurements are memoized, neighbors are visited in
sorted parameter order, and a move requires beating the incumbent by
``HYSTERESIS``, so given the same measurements the search walks the same
path as the reference's. Tests inject a synthetic ``measure``. On the card
a candidate's time is its kernel's device time from ``torch.profiler``,
each call after an L2 flush, the median of the windows
(``kernels/timing.flushed_ms``, as ``chip_smoke.py`` times its kernel
table); on the CPU the plain versions run (they have no knob: the wrappers
check the knob and ignore it), so a CPU entry times the plain version and
ranks nothing, but every candidate is still held against the reference.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Callable, Optional, Union

from repro_torch.roofline.prior import H100, HardwareSpec, roofline_ceiling_s

HYSTERESIS = 0.03        # a neighbor must win by >=3% to displace the
                         # incumbent: timing-noise damper + determinism
MAX_STEPS = 8            # hillclimb iterations (ladders are short)
ELEM_BYTES = {"bfloat16": 2, "float32": 4}
H100_SMS = 132           # decode's split rule without a card: an H100 SXM's

Ladders = dict[str, tuple[int, ...]]
Config = dict[str, int]


# -- kernel registry -----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One tunable kernel: candidate ladders, input builder, reference.

    ``ladders`` and ``default`` are dicts, or functions of the shape where
    the kernel's ladder or rule depends on it. ``build(shape, seed,
    device)`` returns ``(args, ref_out)``, the reference being the plain
    version in fp32; ``call(cfg, *args)`` runs the kernel (on CPU tensors
    its plain version); ``cost(shape)`` returns the (flops, bytes) of the
    roofline ceiling. ``divides_seq`` names params that must divide the
    sequence length. ``fits(shape, cfg)`` holds the port's own limits of a
    kernel; without it a param may be no longer than the sequence, the
    reference's rule for its block sizes. ``iters``: calls per timed
    window on the card."""
    name: str
    ladders: Union[Ladders, Callable[[dict], Ladders]]
    default: Union[Config, Callable[[dict], Config]]
    build: Callable[..., tuple]
    call: Callable[..., object]
    cost: Callable[..., tuple[float, float]]
    divides_seq: tuple[str, ...] = ()
    tol: float = 2e-2
    fits: Optional[Callable[[dict, dict], bool]] = None
    iters: int = 10


def ladders_of(spec: KernelSpec, shape: dict) -> Ladders:
    return spec.ladders(shape) if callable(spec.ladders) else spec.ladders


def _default_of(spec: KernelSpec, shape: dict) -> Config:
    return spec.default(shape) if callable(spec.default) else spec.default


def _torch_dtype(shape: dict):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        shape["dtype"]]


def _normal(gen, size, dtype, scale=1.0):
    import torch
    return (torch.randn(size, generator=gen, device=gen.device)
            * scale).to(dtype)


def _generator(seed: int, device):
    import torch
    return torch.Generator(device=device).manual_seed(seed)


def _holds(check, *args) -> bool:
    """Whether a kernel module's ``check_*`` takes its arguments."""
    try:
        check(*args)
    except ValueError:
        return False
    return True


# The costs: the arithmetic of chip_smoke.py's bounds, which call these, at
# the operands' dtypes (bf16 activations; fp32 logw, dt, A, D and u).
def _cost_flash(shape: dict) -> tuple[float, float]:
    """Causal: query i sees i + 1 keys; q, k, v read once and o written
    once."""
    b, s, h, kv, d = (shape[k] for k in ("b", "s", "h", "kv", "d"))
    flops = 4 * d * b * h * (s * (s + 1) // 2)
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * \
        ELEM_BYTES[shape["dtype"]]
    return flops, nbytes


def _build_flash(shape: dict, seed: int, device):
    from repro_torch.kernels import flash_attention as fa
    b, s, h, kv, d = (shape[k] for k in ("b", "s", "h", "kv", "d"))
    gen, dt = _generator(seed, device), _torch_dtype(shape)
    q = _normal(gen, (b, s, h, d), dt)
    k = _normal(gen, (b, s, kv, d), dt)
    v = _normal(gen, (b, s, kv, d), dt)
    want = fa.flash_attention_plain(*(t.float().permute(0, 2, 1, 3)
                                      for t in (q, k, v)))
    return (q, k, v), want.permute(0, 2, 1, 3)


def _call_flash(cfg, q, k, v):
    from repro_torch.kernels import ops
    return ops.flash_attention(q, k, v, group=cfg["group"])


def _flash_group_rule(shape: dict) -> int:
    from repro_torch.kernels import flash_attention as fa
    return fa.default_group(shape["b"], shape["s"], shape["h"], shape["kv"])


def _flash_ladders(shape: dict) -> Ladders:
    """Powers of two below B * H, B * H itself, and the kernel's own rule
    where it is none of those."""
    bh = shape["b"] * shape["h"]
    rungs = {1 << i for i in range(bh.bit_length()) if 1 << i < bh}
    return {"group": tuple(sorted(rungs | {bh, _flash_group_rule(shape)}))}


def _flash_fits(shape: dict, cfg: dict) -> bool:
    from repro_torch.kernels import flash_attention as fa
    return _holds(fa.check_group, cfg["group"], shape["b"], shape["h"],
                  _torch_dtype(shape))


def _cache_lens(shape: dict) -> list[int]:
    """The reference's cache lengths: ragged, below the buffer."""
    return [(shape["s"] * 3) // 4 - 37 * i for i in range(shape["b"])]


def _cost_decode(shape: dict, valid: Optional[int] = None
                 ) -> tuple[float, float]:
    """Each valid cache position's k and v read once per kv head; q, o and
    cache_len once. ``valid``: the valid positions of the inputs, by
    default those of ``_cache_lens``."""
    b, s, h, kv, d = (shape[k] for k in ("b", "s", "h", "kv", "d"))
    if valid is None:
        valid = sum(min(n, s) for n in _cache_lens(shape))
    flops = 4 * h * d * valid
    nbytes = (2 * valid * kv * d + 2 * b * h * d) * \
        ELEM_BYTES[shape["dtype"]] + 4 * b
    return flops, nbytes


def _build_decode(shape: dict, seed: int, device):
    import torch

    from repro_torch.kernels import decode_attention as dec
    b, s, h, kv, d = (shape[k] for k in ("b", "s", "h", "kv", "d"))
    gen, dt = _generator(seed, device), _torch_dtype(shape)
    q = _normal(gen, (b, 1, h, d), dt)
    kc = _normal(gen, (b, s, kv, d), dt)
    vc = _normal(gen, (b, s, kv, d), dt)
    clen = torch.tensor(_cache_lens(shape), dtype=torch.int32, device=device)
    want = dec.decode_attention_plain(
        q[:, 0].float(), kc.float().permute(0, 2, 1, 3),
        vc.float().permute(0, 2, 1, 3), clen)
    return (q, kc, vc, clen), want[:, None]


def _call_decode(cfg, q, kc, vc, clen):
    from repro_torch.kernels import ops
    return ops.decode_attention(q, kc, vc, clen, split=cfg["split"])


def _sm_count() -> int:
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).multi_processor_count
    return H100_SMS


def _decode_rule(shape: dict) -> Config:
    from repro_torch.kernels import decode_attention as dec
    return {"split": dec.split_size(shape["s"], shape["b"] * shape["kv"],
                                    ELEM_BYTES[shape["dtype"]], _sm_count())}


def _decode_fits(shape: dict, cfg: dict) -> bool:
    from repro_torch.kernels import decode_attention as dec
    return _holds(dec.check_split, cfg["split"], shape["d"],
                  shape["h"] // shape["kv"], ELEM_BYTES[shape["dtype"]])


def _cost_ssd(shape: dict) -> tuple[float, float]:
    """x read and y written, dt read, B and C once per group (G = 1 unless
    the shape names ``g``), A and D once; 4 N P FLOP per token and head
    (the state update and y)."""
    b, s, h, p, n = (shape[k] for k in ("b", "s", "h", "p", "n"))
    g, elem = shape.get("g", 1), ELEM_BYTES[shape["dtype"]]
    flops = 4 * n * p * b * s * h
    nbytes = 2 * b * s * h * p * elem + 4 * b * s * h + \
        2 * b * s * g * n * elem + 2 * 4 * h
    return flops, nbytes


def _build_ssd(shape: dict, seed: int, device):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mamba2_ssd as ssd
    b, s, h, p, n = (shape[k] for k in ("b", "s", "h", "p", "n"))
    g = shape.get("g", 1)
    gen, dt = _generator(seed, device), _torch_dtype(shape)
    x = _normal(gen, (b, s, h, p), dt, 0.5)
    dtv = F.softplus(_normal(gen, (b, s, h), torch.float32) - 1.0)
    A = -torch.exp(_normal(gen, (h,), torch.float32, 0.3))
    Bm = _normal(gen, (b, s, g, n), dt, 0.5)
    Cm = _normal(gen, (b, s, g, n), dt, 0.5)
    D = torch.ones(h, device=device)
    want = ssd.ssd_plain(x.float().permute(0, 2, 1, 3), dtv.permute(0, 2, 1),
                         A, Bm.float().permute(0, 2, 1, 3),
                         Cm.float().permute(0, 2, 1, 3), D)
    return (x, dtv, A, Bm, Cm, D), want.permute(0, 2, 1, 3)


def _call_ssd(cfg, *args):
    from repro_torch.kernels import ops
    return ops.mamba2_ssd(*args, state_tile=cfg["state_tile"])


def _ssd_fits(shape: dict, cfg: dict) -> bool:
    from repro_torch.kernels import mamba2_ssd as ssd
    return _holds(ssd.check_state_tile, cfg["state_tile"],
                  _torch_dtype(shape))


def _cost_wkv6(shape: dict) -> tuple[float, float]:
    """r, k, v read and y written, logw read in fp32, u once; 4 K^2 FLOP
    per token and head (y and the state update)."""
    b, s, h, k = (shape[kk] for kk in ("b", "s", "h", "k"))
    flops = 4 * k * k * b * s * h
    nbytes = b * s * h * k * (4 * ELEM_BYTES[shape["dtype"]] + 4) + 4 * h * k
    return flops, nbytes


def _build_wkv6(shape: dict, seed: int, device):
    import torch

    from repro_torch.kernels import wkv6 as wkv
    b, s, h, k = (shape[kk] for kk in ("b", "s", "h", "k"))
    gen, dt = _generator(seed, device), _torch_dtype(shape)
    r, kk_, v = (_normal(gen, (b, s, h, k), dt, 0.5) for _ in range(3))
    logw = -torch.exp(-7.0 + 6.3 * torch.rand((b, s, h, k), generator=gen,
                                              device=device))
    u = _normal(gen, (h, k), torch.float32, 0.3)
    want = wkv.wkv6_plain(*(t.float().permute(0, 2, 1, 3)
                            for t in (r, kk_, v, logw)), u)
    return (r, kk_, v, logw, u), want.permute(0, 2, 1, 3)


def _call_wkv6(cfg, *args):
    from repro_torch.kernels import ops
    return ops.wkv6(*args, value_tile=cfg["value_tile"])


def _wkv6_fits(shape: dict, cfg: dict) -> bool:
    from repro_torch.kernels import wkv6 as wkv
    return _holds(wkv.check_value_tile, cfg["value_tile"],
                  _torch_dtype(shape))


KERNELS: dict[str, KernelSpec] = {
    "flash_attention": KernelSpec(
        "flash_attention", ladders=_flash_ladders,
        default=lambda shape: {"group": _flash_group_rule(shape)},
        build=_build_flash, call=_call_flash, cost=_cost_flash,
        fits=_flash_fits),
    "decode_attention": KernelSpec(
        "decode_attention", ladders={"split": (32, 64, 128)},
        default=_decode_rule, build=_build_decode, call=_call_decode,
        cost=_cost_decode, fits=_decode_fits, iters=50),
    "mamba2_ssd": KernelSpec(
        "mamba2_ssd", ladders={"state_tile": (32, 64)},
        default={"state_tile": 64}, build=_build_ssd, call=_call_ssd,
        cost=_cost_ssd, fits=_ssd_fits),
    "rwkv6": KernelSpec(
        "rwkv6", ladders={"value_tile": (32, 64)},
        default={"value_tile": 64}, build=_build_wkv6, call=_call_wkv6,
        cost=_cost_wkv6, fits=_wkv6_fits),
}


def legal(spec: KernelSpec, shape: dict, cfg: dict) -> bool:
    """A candidate is legal when every param is on its ladder, divides the
    sequence where ``divides_seq`` asks it to, and fits the kernel's limits
    (``spec.fits``; without it, every param no longer than the sequence)."""
    s = shape["s"]
    ladders = ladders_of(spec, shape)
    for p, v in cfg.items():
        if v not in ladders[p] or (spec.fits is None and v > s):
            return False
        if p in spec.divides_seq and s % v:
            return False
    return spec.fits is None or spec.fits(shape, cfg)


def seed_config(spec: KernelSpec, shape: dict) -> dict:
    """The default (for the port's kernels, what the main path launches
    today), stepped down each ladder until legal for this shape."""
    cfg = dict(_default_of(spec, shape))
    ladders = ladders_of(spec, shape)
    for p in cfg:
        ladder = ladders[p]
        i = ladder.index(cfg[p])
        while i >= 0 and not legal(spec, shape, {**cfg, p: ladder[i]}):
            i -= 1
        if i < 0:
            raise ValueError(
                f"{spec.name}: no legal {p} for shape {shape}")
        cfg[p] = ladder[i]
    return cfg


# -- deterministic hillclimb --------------------------------------------
def hillclimb(spec: KernelSpec, shape: dict,
              measure: Callable[[dict], float], *,
              start: Optional[dict] = None,
              max_steps: int = MAX_STEPS) -> tuple[dict, float, int]:
    """Greedy coordinate descent from the seeded default: per step, time
    every +-1 ladder neighbor (sorted param order, memoized) and move to
    the best one iff it beats the incumbent by ``HYSTERESIS``. Returns
    (best_config, best_seconds, candidates_measured)."""
    memo: dict[tuple, float] = {}
    ladders = ladders_of(spec, shape)

    def key(cfg):
        return tuple(sorted(cfg.items()))

    def timed(cfg):
        k = key(cfg)
        if k not in memo:
            memo[k] = measure(cfg)
        return memo[k]

    cur = dict(start) if start else seed_config(spec, shape)
    cur_t = timed(cur)
    for _ in range(max_steps):
        best_cfg, best_t = cur, cur_t
        for p in sorted(ladders):
            ladder = ladders[p]
            i = ladder.index(cur[p])
            for j in (i - 1, i + 1):
                if not 0 <= j < len(ladder):
                    continue
                cand = {**cur, p: ladder[j]}
                if not legal(spec, shape, cand):
                    continue
                t = timed(cand)
                if t < best_t * (1.0 - HYSTERESIS):
                    best_cfg, best_t = cand, t
        if best_cfg == cur:
            break
        cur, cur_t = best_cfg, best_t
    return cur, cur_t, len(memo)


# -- measurement ---------------------------------------------------------
def _card_measure(spec: KernelSpec, args, flush) -> Callable[[dict], float]:
    """Seconds a call: the kernel's device time from the profiler, each
    call after an L2 flush, the median of the windows; one call must be
    one kernel."""
    from repro_torch.kernels.timing import flushed_ms

    def measure(cfg: dict) -> float:
        return flushed_ms(lambda: spec.call(cfg, *args), spec.iters, flush,
                          per_call=1) / 1e3
    return measure


def _plain_measure(spec: KernelSpec, args, *,
                   reps: int = 3) -> Callable[[dict], float]:
    """Median-of-reps host wall time per call of the plain version (after
    a warm call): the CPU has no kernel, so this ranks nothing."""
    def measure(cfg: dict) -> float:
        spec.call(cfg, *args)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            spec.call(cfg, *args)
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2]
    return measure


def default_measure(spec: KernelSpec, args, device, *,
                    reps: int = 3) -> Callable[[dict], float]:
    """The tuner's timing of ``spec`` on ``args``: the kernel's device
    time on the card, the plain version's host time on the CPU."""
    if device.type == "cuda":
        from repro_torch.kernels.timing import l2_flush_buffer
        return _card_measure(spec, args, l2_flush_buffer(device))
    return _plain_measure(spec, args, reps=reps)


def output_err(out, ref_out) -> float:
    """The largest |out - ref| / (1 + |ref|), so that ``err <= tol`` is
    tests/test_kernels.py's ``allclose(rtol=tol, atol=tol)`` (NaN when the
    output holds one, which no tolerance takes)."""
    out = out.float()
    return float(((out - ref_out).abs() / (1.0 + ref_out.abs())).max())


def max_err(spec: KernelSpec, args, ref_out, cfg: dict) -> float:
    """``output_err`` of one call against the fp32 reference. It takes the
    place of the reference's ``max_abs_err``: the reference tunes fp32
    inputs whose outputs are of order 1, while the bf16 WKV6 and SSD
    outputs at the serving shapes reach tens, where one bf16 rounding is
    0.125 and tests/test_kernels.py's bf16 tolerance is relative there."""
    return output_err(spec.call(cfg, *args), ref_out)


def default_family(device=None) -> str:
    """The accelerator family tuning runs against: the card's name as
    torch reports it (e.g. ``NVIDIA H100 80GB HBM3``) on a CUDA
    ``device`` (by default, when torch sees a card), else ``cpu``."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


# the CPU "hardware": nominal constants so that a CPU entry's roofline
# fraction is defined (it measures the plain version on the host, not a
# kernel on a card)
CPU_HW = HardwareSpec("cpu", peak_flops=50e9, hbm_bw=20e9, ici_bw=1.0)
FAMILY_HW: dict[str, HardwareSpec] = {"cpu": CPU_HW}


def _family_hw(family: str) -> HardwareSpec:
    if family in FAMILY_HW:
        return FAMILY_HW[family]
    if "H100" in family:
        return H100
    raise ValueError(f"no roofline constants for the family {family!r}")


# -- the tuning cache ----------------------------------------------------
def shape_key(shape: dict) -> str:
    return ",".join(f"{k}={shape[k]}" for k in sorted(shape))


def cache_key(kernel: str, shape: dict, family: str) -> str:
    return f"{kernel}|{shape_key(shape)}|{family}"


class TuningCache:
    """Persisted (kernel, shape, family) -> tuning entry map.

    The JSON layout is the reference's ``BENCH_kernels.json``: a dict of
    ``kernel|shape|family`` keys, each holding the winning config, the
    timings that won it, the achieved fraction of the roofline ceiling,
    and the error against the reference."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: dict[str, dict] = {}
        if path:
            self.load(path)

    def load(self, path: str) -> "TuningCache":
        self.path = path
        try:
            with open(path) as f:
                blob = json.load(f)
            self.entries = dict(blob.get("entries", blob))
        except (OSError, json.JSONDecodeError):
            self.entries = {}
        return self

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            raise ValueError("TuningCache.save: no path")
        with open(path, "w") as f:
            json.dump({"entries": dict(sorted(self.entries.items()))},
                      f, indent=1, sort_keys=True)

    def put(self, entry: dict) -> None:
        self.entries[cache_key(entry["kernel"], entry["shape"],
                               entry["family"])] = entry

    def get(self, kernel: str, shape: dict,
            family: str) -> Optional[dict]:
        return self.entries.get(cache_key(kernel, shape, family))

    def best_config(self, kernel: str, shape: dict, family: str,
                    default: Optional[dict] = None) -> Optional[dict]:
        """The tuned config for an exact (kernel, shape, family) hit,
        else ``default``."""
        e = self.get(kernel, shape, family)
        return dict(e["config"]) if e else default


# -- the tuner entry point ----------------------------------------------
def autotune(kernel: str, shape: dict, *, device="cuda",
             family: Optional[str] = None, seed: int = 0, reps: int = 3,
             measure: Optional[Callable[[dict], float]] = None,
             cache: Optional[TuningCache] = None) -> dict:
    """Tune one (kernel, shape) on ``device`` (the card unless the caller
    asks for the CPU) and return (and cache) the tuning entry. ``measure``
    overrides the timing function (tests inject deterministic synthetic
    costs). Raises if the winner's error passes the kernel's ``tol``."""
    import torch
    spec = KERNELS[kernel]
    device = torch.device(device)
    family = family or default_family(device)
    args, ref_out = spec.build(shape, seed, device)
    if measure is None:
        measure = default_measure(spec, args, device, reps=reps)
    default = seed_config(spec, shape)
    # one memoized timing per config, shared between the default
    # measurement and the hillclimb: the same config must never carry
    # two (noisy) timings, or speedup_vs_default could dip below 1.0
    # for the config the climb never left
    memo: dict[tuple, float] = {}

    def timed(cfg: dict) -> float:
        k = tuple(sorted(cfg.items()))
        if k not in memo:
            memo[k] = measure(cfg)
        return memo[k]

    default_t = timed(default)
    best, best_t, n_meas = hillclimb(spec, shape, timed, start=default)
    err = max_err(spec, args, ref_out, best)
    hw = _family_hw(family)
    flops, nbytes = spec.cost(shape)
    ceiling = roofline_ceiling_s(flops, nbytes, hw)
    entry = {
        "kernel": kernel, "shape": dict(shape), "family": family,
        "config": best, "default_config": default,
        "us": best_t * 1e6, "default_us": default_t * 1e6,
        "speedup_vs_default": default_t / max(best_t, 1e-12),
        "candidates_measured": n_meas,
        "roofline_ceiling_us": ceiling * 1e6,
        "roofline_fraction": ceiling / max(best_t, 1e-12),
        "max_err": err, "tol": spec.tol,
        "mode": "cuda" if device.type == "cuda" else "plain",
    }
    if not err <= spec.tol:
        raise AssertionError(f"{kernel}{shape}: tuned config {best} diverges "
                             f"from the reference (err {err:.3e} > "
                             f"{spec.tol})")
    if not math.isfinite(best_t):
        raise RuntimeError(f"{kernel}: non-finite timing")
    if cache is not None:
        cache.put(entry)
    return entry


# the reference's smoke shapes (small enough for the plain versions on the
# CPU; a ragged sequence and an odd head dim included), in bf16, the dtype
# of the knobs
SMOKE_SHAPES: dict[str, list[dict]] = {
    "flash_attention": [
        {"b": 1, "s": 256, "h": 4, "kv": 2, "d": 64, "dtype": "bfloat16"},
        {"b": 1, "s": 192, "h": 2, "kv": 2, "d": 80, "dtype": "bfloat16"},
    ],
    "decode_attention": [{"b": 2, "s": 1024, "h": 4, "kv": 2, "d": 64,
                          "dtype": "bfloat16"}],
    "mamba2_ssd": [{"b": 1, "s": 256, "h": 4, "p": 64, "n": 32,
                    "dtype": "bfloat16"}],
    "rwkv6": [{"b": 1, "s": 256, "h": 2, "k": 64, "dtype": "bfloat16"}],
}

# the serving paths' shapes, those of PERF.md's kernel table: 4 x 2048
# prefills of olmo-1b (16 heads of 128) and zamba2-7b (32 of 112), olmo-1b's
# decode (4 slots, a buffer of 1024, 16 heads of 128), rwkv6-7b's WKV6 (64
# heads of 64) and zamba2-7b's SSD (112 heads, P 64, N 64, one group)
SERVING_SHAPES: dict[str, list[dict]] = {
    "flash_attention": [
        {"b": 4, "s": 2048, "h": 16, "kv": 16, "d": 128, "dtype": "bfloat16"},
        {"b": 4, "s": 2048, "h": 32, "kv": 32, "d": 112, "dtype": "bfloat16"},
    ],
    "decode_attention": [{"b": 4, "s": 1024, "h": 16, "kv": 16, "d": 128,
                          "dtype": "bfloat16"}],
    "rwkv6": [{"b": 4, "s": 2048, "h": 64, "k": 64, "dtype": "bfloat16"}],
    "mamba2_ssd": [{"b": 4, "s": 2048, "h": 112, "p": 64, "n": 64,
                    "dtype": "bfloat16"}],
}


def autotune_all(*, device="cuda", family: Optional[str] = None,
                 seed: int = 0, reps: int = 3,
                 shapes: Optional[dict[str, list[dict]]] = None,
                 cache: Optional[TuningCache] = None) -> list[dict]:
    shapes = shapes or SMOKE_SHAPES
    out = []
    for kernel, shape_list in shapes.items():
        for shape in shape_list:
            out.append(autotune(kernel, shape, device=device, family=family,
                                seed=seed, reps=reps, cache=cache))
    return out
