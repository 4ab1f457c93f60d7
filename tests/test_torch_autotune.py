"""The port's autotuner and roofline prior against the reference's.

The same specs and synthetic measures walk the same hillclimb in both
packages; ``seed_config``, ``legal``, the cache's keys and bytes, the
roofline arithmetic and the profiler's prior-backed predictions are equal;
the port's own registry seeds at today's launch rules, bounds its serving
shapes as PERF.md's kernel table does, and tunes on the CPU through the
plain versions. Data passes between the packages as plain Python."""
import ast
import itertools
import json
import math
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core.engine.cluster import Cluster as RCluster  # noqa: E402
from repro.core.engine.events import EventBus as REventBus  # noqa: E402
from repro.core.engine.launcher import VirtualRunner as RRunner  # noqa: E402
from repro.core.engine.placement import Placement as RPlacement  # noqa: E402
from repro.core.engine.registry import JobRegistry as RRegistry  # noqa: E402
from repro.core.engine.registry import JobSpec as RJobSpec  # noqa: E402
from repro.core.engine.scheduler import Scheduler as RScheduler  # noqa: E402
from repro.core.provision import autotune as RA  # noqa: E402
from repro.core.provision import profiler as RP  # noqa: E402
from repro.roofline import prior as RR  # noqa: E402
from repro_torch.core.engine.cluster import Cluster as PCluster  # noqa: E402
from repro_torch.core.engine.events import EventBus as PEventBus  # noqa: E402
from repro_torch.core.engine.launcher import (  # noqa: E402
    VirtualRunner as PRunner)
from repro_torch.core.engine.placement import (  # noqa: E402
    Placement as PPlacement)
from repro_torch.core.engine.registry import (  # noqa: E402
    JobRegistry as PRegistry)
from repro_torch.core.engine.registry import JobSpec as PJobSpec  # noqa: E402
from repro_torch.core.engine.scheduler import (  # noqa: E402
    Scheduler as PScheduler)
from repro_torch.core.provision import autotune as PA  # noqa: E402
from repro_torch.core.provision import profiler as PP  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402
from repro_torch.roofline import prior as PR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_KERNELS = sorted(RA.KERNELS)
# a shape per reference kernel, and ragged ones no default chunk divides
REF_SHAPES = {
    "flash_attention": [{"b": 1, "s": 256, "h": 2, "kv": 2, "d": 64},
                        {"b": 1, "s": 192, "h": 2, "kv": 2, "d": 80},
                        {"b": 1, "s": 100, "h": 2, "kv": 1, "d": 64}],
    "decode_attention": [{"b": 2, "s": 1024, "h": 4, "kv": 2, "d": 64},
                         {"b": 1, "s": 384, "h": 2, "kv": 2, "d": 64}],
    "mamba2_ssd": [{"b": 1, "s": 256, "h": 2, "p": 32, "n": 16},
                   {"b": 1, "s": 192, "h": 2, "p": 32, "n": 16},
                   {"b": 1, "s": 96, "h": 2, "p": 32, "n": 16}],
    "rwkv6": [{"b": 1, "s": 256, "h": 2, "k": 64},
              {"b": 1, "s": 320, "h": 2, "k": 64}],
}


def _port_spec(ref):
    """A port KernelSpec with the reference spec's ladders, default and
    divides_seq (and no ``fits``: the reference's length rule)."""
    return PA.KernelSpec(ref.name, ladders=ref.ladders, default=ref.default,
                         build=ref.build, call=ref.call, cost=ref.cost,
                         divides_seq=ref.divides_seq, tol=ref.tol)


def _walk(hillclimb, spec, shape, landscape):
    calls = []

    def measure(cfg):
        calls.append(tuple(sorted(cfg.items())))
        return landscape(cfg)
    best, best_t, n = hillclimb(spec, shape, measure)
    return best, best_t, n, calls


def _flash_cost(cfg):
    """tests/test_autotune_prior.py's convex landscape, optimum (64, 256)."""
    return (1.0 + abs(math.log2(cfg["block_q"]) - 6)
            + 0.5 * abs(math.log2(cfg["block_k"]) - 8)) * 1e-3


def _flat(cfg):
    """tests/test_autotune_prior.py's flat landscape: within 3% of the
    default, so nothing displaces it."""
    (v,) = cfg.values()
    return 1.0 + 0.01 * math.log2(v)


@pytest.mark.parametrize("kernel,shape,landscape", [
    ("flash_attention", {"b": 1, "s": 256, "h": 2, "kv": 2, "d": 64},
     _flash_cost),
    ("mamba2_ssd", {"b": 1, "s": 256, "h": 2, "p": 32, "n": 16}, _flat),
    ("rwkv6", {"b": 1, "s": 256, "h": 2, "k": 64}, _flat),
    ("decode_attention", {"b": 2, "s": 1024, "h": 4, "kv": 2, "d": 64},
     _flat),
])
def test_hillclimb_walks_the_reference_path(kernel, shape, landscape):
    ref = RA.KERNELS[kernel]
    want = _walk(RA.hillclimb, ref, shape, landscape)
    got = _walk(PA.hillclimb, _port_spec(ref), shape, landscape)
    assert got == want
    if landscape is _flash_cost:
        assert got[0] == {"block_q": 64, "block_k": 256}


@settings(max_examples=60, deadline=None)
@given(kernel=st.sampled_from(REF_KERNELS),
       s=st.sampled_from([32, 64, 96, 128, 192, 256, 320, 512, 1024]),
       values=st.lists(st.floats(0.5, 2.0), min_size=16, max_size=16),
       max_steps=st.integers(1, 8))
def test_hillclimb_walks_the_reference_path_on_random_landscapes(
        kernel, s, values, max_steps):
    ref = RA.KERNELS[kernel]
    shape = dict(REF_SHAPES[kernel][0], s=s)
    params = sorted(ref.ladders)
    grid = list(itertools.product(*(ref.ladders[p] for p in params)))

    def landscape(cfg):
        return values[grid.index(tuple(cfg[p] for p in params))]
    try:
        want = _walk(lambda *a: RA.hillclimb(*a, max_steps=max_steps), ref,
                     shape, landscape)
    except ValueError:           # no legal seed at this length: both raise
        with pytest.raises(ValueError, match="no legal"):
            PA.seed_config(_port_spec(ref), shape)
        return
    got = _walk(lambda *a: PA.hillclimb(*a, max_steps=max_steps),
                _port_spec(ref), shape, landscape)
    assert got == want


def _outcome(fn, *args):
    """fn's result, or the type and message of what it raised."""
    try:
        return fn(*args)
    except ValueError as err:
        return ValueError, str(err)


@pytest.mark.parametrize("kernel", REF_KERNELS)
def test_seed_config_and_legal_match_the_reference(kernel):
    ref = RA.KERNELS[kernel]
    port = _port_spec(ref)
    for shape in REF_SHAPES[kernel]:
        assert _outcome(PA.seed_config, port, shape) == \
            _outcome(RA.seed_config, ref, shape)
        params = sorted(ref.ladders)
        for combo in itertools.product(*(ref.ladders[p] for p in params)):
            cfg = dict(zip(params, combo))
            assert PA.legal(port, shape, cfg) == RA.legal(ref, shape, cfg)
    # tests/test_autotune_prior.py's ragged cases
    assert PA.seed_config(_port_spec(RA.KERNELS["mamba2_ssd"]), {
        "b": 1, "s": 192, "h": 2, "p": 32, "n": 16}) == {"chunk": 64}
    assert PA.seed_config(_port_spec(RA.KERNELS["flash_attention"]), {
        "b": 1, "s": 192, "h": 2, "kv": 2, "d": 80}) == \
        {"block_q": 128, "block_k": 128}


def test_tuning_cache_reads_the_committed_file_and_writes_its_bytes(
        tmp_path):
    path = str(ROOT / "BENCH_kernels.json")
    port, ref = PA.TuningCache(path), RA.TuningCache(path)
    assert port.entries == ref.entries and port.entries
    for key, entry in ref.entries.items():
        assert PA.cache_key(entry["kernel"], entry["shape"],
                            entry["family"]) == key
        assert port.get(entry["kernel"], entry["shape"],
                        entry["family"]) == entry
        assert port.best_config(entry["kernel"], entry["shape"],
                                entry["family"]) == entry["config"]
    extra = {"kernel": "rwkv6", "family": "NVIDIA H100 80GB HBM3",
             "shape": {"b": 4, "s": 2048, "h": 64, "k": 64,
                       "dtype": "bfloat16"},
             "config": {"value_tile": 32}, "us": 230.5, "max_err": 1e-3,
             "tol": 2e-2}
    port.put(extra)
    ref.put(extra)
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    # a miss serves the caller's default untouched
    assert PA.TuningCache(str(tmp_path / "port.json")).best_config(
        "rwkv6", dict(extra["shape"], dtype="float32"), extra["family"],
        default={"value_tile": 64}) == {"value_tile": 64}


@settings(max_examples=50, deadline=None)
@given(shape=st.dictionaries(
    st.sampled_from(["b", "s", "h", "kv", "d", "p", "n", "k", "g"]),
    st.integers(1, 4096), min_size=1, max_size=6),
    dtype=st.sampled_from(["bfloat16", "float32"]),
    kernel=st.sampled_from(sorted(PA.KERNELS)),
    family=st.sampled_from(["cpu", "interpret", "NVIDIA H100 80GB HBM3"]))
def test_cache_and_shape_keys_match_the_reference(shape, dtype, kernel,
                                                  family):
    shape = dict(shape, dtype=dtype)
    assert PA.shape_key(shape) == RA.shape_key(shape)
    assert PA.cache_key(kernel, shape, family) == \
        RA.cache_key(kernel, shape, family)


def _specs(mod, peak, bw, ici, startup, ref_chips):
    return {"cpu": mod.HardwareSpec("cpu", peak_flops=peak, hbm_bw=bw,
                                    ici_bw=ici),
            "pod": mod.HardwareSpec("pod", peak_flops=peak, hbm_bw=bw,
                                    ici_bw=ici, startup_s=startup,
                                    scale_dim="chips", ref_chips=ref_chips)}


@settings(max_examples=80, deadline=None)
@given(flops=st.floats(0, 1e18), nbytes=st.floats(0, 1e15),
       coll=st.floats(0, 1e13), n_chips=st.floats(0.1, 512),
       peak=st.floats(1e6, 1e16), bw=st.floats(1e3, 1e13),
       ici=st.sampled_from([0.0, 1.0, 5e10, 4.5e11]),
       startup=st.floats(0, 100), ref_chips=st.sampled_from([1.0, 4.0, 8.0]),
       work=st.floats(0, 1e4), chips=st.floats(1, 64))
def test_roofline_arithmetic_matches_the_reference(
        flops, nbytes, coll, n_chips, peak, bw, ici, startup, ref_chips,
        work, chips):
    ports = _specs(PR, peak, bw, ici, startup, ref_chips)
    refs = _specs(RR, peak, bw, ici, startup, ref_chips)
    for name in ports:
        assert PR.roofline_ceiling_s(flops, nbytes, ports[name], coll,
                                     n_chips) == \
            RR.roofline_ceiling_s(flops, nbytes, refs[name], coll, n_chips)
    cfg = {"work": work, "chips": chips}
    costs = dict(flops=lambda c: c["work"] * 1e9, nbytes=nbytes,
                 coll_bytes=lambda c: c["work"] * coll * 1e-4)
    assert PR.TemplateCost(**costs).evaluate(cfg) == \
        RR.TemplateCost(**costs).evaluate(cfg)
    port = PR.RooflinePrior(ports).register("work", **costs)
    ref = RR.RooflinePrior(refs).register("work", **costs)
    for family in ("cpu", "pod", "gpu"):
        assert port.can_estimate("work", family) == \
            ref.can_estimate("work", family)
        if ref.can_estimate("work", family):
            assert port.estimate("work", family, cfg) == \
                ref.estimate("work", family, cfg)
    with pytest.raises(KeyError):
        port.estimate("train", "cpu", cfg)


def test_the_prior_holds_no_tpu_number_and_no_hlo_parser():
    assert not hasattr(PR, "TPU_V5E")
    assert PR.H100.peak_flops == 989e12 and PR.H100.hbm_bw == 3.35e12
    assert PR.H100.ici_bw == 450e9
    assert PR.HardwareSpec("x", 1.0, 1.0).ici_bw != RR.HardwareSpec(
        "x", 1.0, 1.0).ici_bw
    with pytest.raises(NotImplementedError, match="A11"):
        PR.TemplateCost.from_hlo("HloModule m")
    with pytest.raises(NotImplementedError, match="A11"):
        PR.RooflinePrior({"h100": PR.H100}).register_hlo("t", "HloModule m")


# -- the profiler with each package's prior: the reference's scenarios -----
def _prior(mod):
    cpu = mod.HardwareSpec("cpu", peak_flops=1e9, hbm_bw=1.0, ici_bw=5e10)
    tpu = mod.HardwareSpec("tpu", peak_flops=1e9, hbm_bw=1.0, ici_bw=5e10,
                           startup_s=30.0, scale_dim="chips", ref_chips=1.0)
    return mod.RooflinePrior({"cpu": cpu, "tpu": tpu}).register(
        "work", flops=lambda cfg: cfg["work"] * 1e9)


def _sources(prof, queries):
    out = []
    for tmpl, pool, cfg in queries:
        src = prof.resolve_source(tmpl, pool, cfg)
        try:
            pred = prof.predict_for_pool(tmpl, pool, cfg)
        except KeyError:
            pred = "KeyError"
        out.append((src, pred, prof.last_source))
    return out


def _cold_then_fitted(P, prior):
    prof = P.Profiler(engine=None, prior=prior)
    cfg = {"work": 100.0, "vcpu": 1.0}
    seen = _sources(prof, [("work", "cpu", cfg)])
    tmpl = P.CommandTemplate("work@cpu", {"work": [50.0, 100.0, 200.0]},
                             {"vcpu": [1.0, 2.0]})
    grid = tmpl.grid()
    prof.fit_offline(tmpl, grid, [2.0 * c["work"] for c in grid])
    return seen + _sources(prof, [("work", "cpu", cfg),
                                  ("train", "cpu", cfg)])


def _out_of_hull(P, prior):
    prof = P.Profiler(engine=None, prior=prior)
    tmpl = P.CommandTemplate("work@cpu", {"work": [5.0, 30.0, 60.0]},
                             {"vcpu": [1.0, 2.0]})
    grid = tmpl.grid()
    prof.fit_offline(tmpl, grid, [c["work"] for c in grid])
    queries = [("work", "cpu", {"work": 30.0, "vcpu": 1.0}),
               ("work", "cpu", {"work": 3600.0, "vcpu": 1.0})]
    seen = _sources(prof, queries)
    prof.prior = None
    return seen + _sources(prof, queries[1:])


def _bootstrap_and_refit(P, prior, Cluster, Placement, JobSpec):
    pools = {"cpu": Cluster({"vcpu": 8.0}, {"vcpu": 0.5}, name="cpu"),
             "tpu": Cluster({"chips": 16.0}, {"chips": 8.0}, name="tpu")}
    placement = Placement(pools, objective="runtime")
    prof = P.Profiler(engine=None, recency_halflife=2.0, prior=prior)
    placement.use_profiler(prof)
    spec = JobSpec(name="j", project="p", user="u", template="work",
                   args={"work": 100.0},
                   pool_resources={"cpu": {"vcpu": 1.0},
                                   "tpu": {"chips": 8.0}})
    ranks = [placement.rank(spec, placement.eligible(spec))]
    for w, t in ((50.0, 50.0), (100.0, 100.0), (200.0, 200.0)):
        prof.add_observation("work@cpu", {"work": w, "vcpu": 1.0}, t)
        prof.add_observation("work@tpu", {"work": w, "chips": 8.0}, t / 10)
    ranks.append(placement.rank(spec, placement.eligible(spec)))
    for w, t in ((50.0, 500.0), (100.0, 1000.0), (200.0, 2000.0),
                 (100.0, 1000.0), (50.0, 500.0), (200.0, 2000.0)):
        prof.add_observation("work@tpu", {"work": w, "chips": 8.0}, t)
    ranks.append(placement.rank(spec, placement.eligible(spec)))
    return ranks + [dict(placement.stats)] + _sources(prof, [
        ("work", "cpu", {"work": 120.0, "vcpu": 1.0}),
        ("work", "tpu", {"work": 120.0, "chips": 8.0})])


def _feedback(P, prior, Cluster, Placement, JobSpec, Registry, Bus, Runner,
              Scheduler):
    registry, bus = Registry(), Bus()
    runner = Runner(registry, bus, oracle=lambda job: job.spec.args["work"])
    sched = Scheduler(registry, runner, bus, quota_k=4, placement=Placement(
        {"cpu": Cluster({"vcpu": 8.0}, {"vcpu": 0.5}, name="cpu")}))
    prof = P.Profiler(engine=None, prior=prior)
    prof.attach_feedback(bus, registry)
    before = _sources(prof, [("work", "cpu", {"work": 20.0, "vcpu": 1.0})])
    for w in (10.0, 20.0, 40.0):
        sched.submit(registry.submit(JobSpec(
            name=f"j{w}", project="p", user="u", template="work",
            args={"work": w}, resources={"vcpu": 1.0})))
    sched.run_to_completion()
    configs, runtimes = prof.training_sets["work@cpu"]
    return before + [prof.has_model("work@cpu"), configs,
                     sorted(runtimes)] + _sources(
        prof, [("work", "cpu", {"work": 20.0, "vcpu": 1.0})])


def _skips(P, prior, JobSpec):
    prof = P.Profiler(engine=None, prior=prior)

    class FakeJob:
        spec = JobSpec(name="j", project="p", user="u", duration=1.0)
        pool = "cpu"
        runtime = 5.0
    return [prof.observe(FakeJob()), prof.training_sets]


def _both(scenario):
    ref = scenario(RP, _prior(RR), RCluster, RPlacement, RJobSpec, RRegistry,
                   REventBus, RRunner, RScheduler)
    port = scenario(PP, _prior(PR), PCluster, PPlacement, PJobSpec,
                    PRegistry, PEventBus, PRunner, PScheduler)
    return port, ref


@pytest.mark.parametrize("scenario", [
    lambda P, pr, *_: _cold_then_fitted(P, pr),
    lambda P, pr, *_: _out_of_hull(P, pr),
    lambda P, pr, C, Pl, J, *_: _bootstrap_and_refit(P, pr, C, Pl, J),
    lambda P, pr, *rest: _feedback(P, pr, *rest),
    lambda P, pr, C, Pl, J, *_: _skips(P, pr, J),
], ids=["prior_serves_cold_then_fitted_takes_over",
        "out_of_hull_model_defers_to_prior",
        "add_observation_bootstraps_and_refits_rank",
        "attach_feedback_observes_finished_jobs",
        "observe_skips_jobs_without_template_or_runtime"])
def test_profiler_with_the_port_prior_predicts_as_the_reference(scenario):
    port, ref = _both(scenario)
    assert port == ref


def test_the_cold_profiler_serves_the_port_prior():
    port, _ = _both(lambda P, pr, *_: _cold_then_fitted(P, pr))
    assert port[0] == ("prior", pytest.approx(100.0), "prior")
    assert port[1] == ("pool-model", pytest.approx(200.0, rel=1e-6),
                       "pool-model")


# -- the port's registry ---------------------------------------------------
def test_seed_config_is_todays_launch_rule_at_the_serving_shapes():
    seeds = {k: [PA.seed_config(PA.KERNELS[k], s) for s in shapes]
             for k, shapes in PA.SERVING_SHAPES.items()}
    assert seeds["flash_attention"] == [{"group": 16}, {"group": 16}]
    assert seeds["flash_attention"][0]["group"] == fa.default_group(
        4, 2048, 16, 16)
    assert seeds["decode_attention"] == [
        {"split": dec.split_size(1024, 64, 2, 132)}] == [{"split": 128}]
    assert seeds["rwkv6"] == [{"value_tile": wkv.DEFAULT_VALUE_TILE}] == \
        [{"value_tile": 64}]
    assert seeds["mamba2_ssd"] == [{"state_tile": ssd.DEFAULT_STATE_TILE}] \
        == [{"state_tile": 64}]
    # the flash ladder: powers of two up to B * H
    assert PA.ladders_of(PA.KERNELS["flash_attention"],
                         PA.SERVING_SHAPES["flash_attention"][0]) == {
        "group": (1, 2, 4, 8, 16, 32, 64)}


def test_flash_rule_off_the_power_of_two_ladder_seeds_as_launched():
    # llama4-scout's 40:8 heads: the kernel's rule groups 80 pairs
    shape = {"b": 4, "s": 2048, "h": 40, "kv": 8, "d": 128,
             "dtype": "bfloat16"}
    spec = PA.KERNELS["flash_attention"]
    assert PA.seed_config(spec, shape) == {"group": 80}
    assert PA.ladders_of(spec, shape)["group"][-3:] == (80, 128, 160)


@pytest.mark.parametrize("kernel,bound_ms", [
    ("flash_attention", [0.0695, 0.1217]), ("rwkv6", [0.1202]),
    ("mamba2_ssd", [0.0718])])
def test_costs_give_the_kernel_tables_bounds(kernel, bound_ms):
    spec = PA.KERNELS[kernel]
    got = [round(PR.roofline_ceiling_s(*spec.cost(s), PR.H100) * 1e3, 4)
           for s in PA.SERVING_SHAPES[kernel]]
    assert got == bound_ms


def test_legal_holds_the_ports_limits():
    flash, decode = PA.KERNELS["flash_attention"], PA.KERNELS[
        "decode_attention"]
    shape = {"b": 1, "s": 64, "h": 4, "kv": 2, "d": 64, "dtype": "bfloat16"}
    assert [g for g in (1, 2, 4, 8) if PA.legal(flash, shape,
                                                {"group": g})] == [1, 2, 4]
    assert not PA.legal(flash, dict(shape, dtype="float32"), {"group": 2})
    # decode's split shares fp32, whose registers hold 64 positions
    for dtype, most in (("bfloat16", 128), ("float32", 64)):
        d_shape = dict(shape, s=1024, dtype=dtype)
        assert max(v for v in (32, 64, 128)
                   if PA.legal(decode, d_shape, {"split": v})) == most
    # a split whose scores and q pass the shared memory cap
    big = {"b": 1, "s": 1024, "h": 32, "kv": 1, "d": 128,
           "dtype": "bfloat16"}
    assert dec.smem_bytes(128, 128, 32, 2) <= dec.SMEM_CAP
    assert PA.legal(decode, big, {"split": 128})
    for kernel, knob in (("rwkv6", "value_tile"), ("mamba2_ssd",
                                                   "state_tile")):
        spec = PA.KERNELS[kernel]
        s = dict(PA.SMOKE_SHAPES[kernel][0])
        assert [PA.legal(spec, s, {knob: v}) for v in (16, 32, 64, 128)] \
            == [False, True, True, False]
        assert not PA.legal(spec, dict(s, dtype="float32"), {knob: 32})


def _cpu_args(kernel, shape):
    return PA.KERNELS[kernel].build(shape, 0, torch.device("cpu"))


@pytest.mark.parametrize("kernel", sorted(PA.KERNELS))
def test_wrappers_check_and_ignore_knobs_on_the_cpu(kernel):
    spec = PA.KERNELS[kernel]
    shape = PA.SMOKE_SHAPES[kernel][0]
    args, _ = _cpu_args(kernel, shape)
    (knob, ladder), = PA.ladders_of(spec, shape).items()
    base = spec.call({knob: None}, *args)
    for value in ladder:
        assert torch.equal(spec.call({knob: value}, *args), base)
    with pytest.raises(ValueError):
        spec.call({knob: 4096}, *args)
    fp32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    if kernel == "decode_attention":       # fp32 shares decode's split
        spec.call({knob: 64}, *fp32)
        with pytest.raises(ValueError, match="within 1 .. 64"):
            spec.call({knob: 128}, *fp32)
    else:
        with pytest.raises(ValueError, match="only the bf16"):
            spec.call({knob: ladder[0]}, *fp32)


def test_autotune_on_the_cpu_returns_the_references_entry():
    ref_keys = {frozenset(e) for e in RA.TuningCache(
        str(ROOT / "BENCH_kernels.json")).entries.values()}
    cache = PA.TuningCache()
    for kernel, shapes in PA.SMOKE_SHAPES.items():
        spec = PA.KERNELS[kernel]
        (knob, ladder), = PA.ladders_of(spec, shapes[0]).items()
        # a landscape whose optimum is the ladder's first rung
        entry = PA.autotune(kernel, shapes[0], device="cpu", cache=cache,
                            measure=lambda cfg: 1.0 + ladder.index(cfg[knob]))
        assert {frozenset(entry)} == ref_keys
        assert entry["config"] == {knob: ladder[0]}
        assert entry["default_config"] == PA.seed_config(spec, shapes[0])
        assert entry["family"] == "cpu" and entry["mode"] == "plain"
        assert 0 <= entry["max_err"] <= entry["tol"] == 2e-2
        assert cache.get(kernel, shapes[0], "cpu") is entry
        assert entry["speedup_vs_default"] == pytest.approx(
            1.0 + ladder.index(entry["default_config"][knob]))
        assert json.loads(json.dumps(entry)) == entry


def test_autotune_refuses_a_winner_past_its_tolerance(monkeypatch):
    spec = PA.KERNELS["rwkv6"]
    broken = PA.KernelSpec(**{**spec.__dict__,
                              "call": lambda cfg, *a: spec.call(cfg, *a)
                              + 1.0})
    monkeypatch.setitem(PA.KERNELS, "rwkv6", broken)
    with pytest.raises(AssertionError, match="diverges"):
        PA.autotune("rwkv6", PA.SMOKE_SHAPES["rwkv6"][0], device="cpu",
                    measure=lambda cfg: 1.0)


def test_output_err_is_allclose_at_tol():
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)) * 40
    out = ref + torch.from_numpy(
        rng.uniform(-1, 1, 1000).astype(np.float32)) * (1 + ref.abs()) * 0.02
    err = PA.output_err(out, ref)
    assert err <= 0.02
    assert torch.allclose(out, ref, rtol=err * 1.0001, atol=err * 1.0001)
    assert not torch.allclose(out, ref, rtol=err * 0.999, atol=err * 0.999)
    assert math.isnan(PA.output_err(out + float("nan"), ref))


KNOBS = {"group", "split", "value_tile", "state_tile"}
KERNEL_CALLS = {"flash_attention", "decode_attention", "wkv6", "mamba2_ssd",
                "flash_attention_bhsd", "decode_attention_bhd", "wkv6_bhsk",
                "ssd_bhsp"}


def test_no_model_serve_or_train_module_passes_a_knob():
    """Every call of a kernel wrapper or adapter outside the kernels and
    the autotuner passes no knob, so the main paths launch today's rules."""
    calls = 0
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        if path.parent.name == "kernels" or path.name == "autotune.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else \
                getattr(func, "id", None)
            if name in KERNEL_CALLS:
                calls += 1
                passed = {kw.arg for kw in node.keywords} & KNOBS
                assert not passed, f"{path}:{node.lineno} passes {passed}"
    assert calls >= 4
