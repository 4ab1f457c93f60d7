"""The port's cost source and roofline (``roofline/op_cost.py``,
``roofline/analysis.py``) against programs of known cost and against the
reference's ``tests/test_roofline.py``: a matmul's FLOPs and bytes, every
trip of a loop and remat's recompute counted, collectives by kind on a
fake (2, 2) mesh, the kernels' fake branches recorded at their
``KernelSpec.cost`` (and a fake tensor outside a count refused), the
peak of live bytes, the roofline's terms, ``model_flops`` equal to the
reference's for every cell, and ``RooflinePrior.register_count`` giving
``analyze``'s step time. Every tensor is on the CPU (fake or real)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.configs.base import get_arch as ref_arch  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.roofline import analysis as REF_RA  # noqa: E402
from repro.roofline.hlo_cost import module_cost  # noqa: E402
from repro_torch.configs.base import get_arch, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core.provision.autotune import KERNELS  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402
from repro_torch.roofline import prior as PR  # noqa: E402


def test_matmul_flops_and_bytes_equal_the_reference_models():
    """2 M N K FLOPs and operands plus result in bytes, as the reference's
    HLO model counts the same product (within its band)."""
    a, b = torch.ones(64, 256), torch.ones(256, 32)
    cost = op_cost.count(torch.matmul, a, b)
    want = 2 * 64 * 256 * 32
    assert cost.flops == want
    assert cost.bytes == cost.bytes_fused == (64 * 256 + 256 * 32
                                              + 64 * 32) * 4
    assert cost.coll_bytes == 0 and not cost.kernels
    ref = module_cost(jax.jit(lambda x, y: x @ y).lower(
        jax.ShapeDtypeStruct((64, 256), jnp.float32),
        jax.ShapeDtypeStruct((256, 32), jnp.float32)).compile().as_text())
    assert want <= ref.flops <= want * 1.05


def test_elementwise_counts_its_result_and_views_count_nothing():
    x = torch.ones(32, 16)

    def f(x):
        y = x.t()                         # a view: nothing moves
        z = torch.empty_like(x)           # allocation without a write
        return (y * 2).sum() + z.numel()

    cost = op_cost.count(f, x)
    n = 32 * 16
    # mul: n results from n operands; sum: 1 result from n; the add of a
    # Python number: 1 from 1
    assert cost.flops == n + 1 + 1
    assert cost.bytes == 4 * (2 * n) + 4 * (n + 1) + 4 * 2
    assert cost.bytes_fused == 0          # no material op


def test_a_convolution_counts_its_window_and_each_gradient():
    """2 |result| window Cin/groups; its backward that for each of the two
    gradients it computes."""
    x = torch.ones(2, 4, 16, requires_grad=True)
    w = torch.ones(6, 2, 3, requires_grad=True)
    conv = lambda: torch.nn.functional.conv1d(x, w, groups=2)  # noqa: E731
    fwd = 2 * (2 * 6 * 14) * 3 * 2
    with torch.no_grad():
        assert op_cost.count(conv).flops == fwd
    y = conv()
    grad = torch.ones_like(y)
    back = op_cost.count(lambda: y.backward(grad))
    assert back.flops == 2 * fwd
    assert back.bytes_fused == back.bytes > 0


def test_every_trip_of_a_loop_counts():
    """The reference's scan test: a loop of 10 matmuls counts 10 of them
    (the port runs each trip; XLA's own analysis counted the body once)."""
    n, trips = 128, 10

    def f(x, w):
        for i in range(trips):
            x = torch.tanh(x @ w[i])
        return x

    cost = op_cost.count(f, torch.ones(n, n), torch.ones(trips, n, n))
    assert cost.flops == trips * (2 * n ** 3 + n * n)


def test_remat_recompute_and_the_backward_count():
    """Under ``checkpoint`` the forward's matmul runs again in the backward,
    and the count has it: one more forward matmul than without."""
    n = 64
    w = torch.ones(n, n, requires_grad=True)

    def step(remat):
        def f(x):
            layer = lambda h: torch.relu(h @ w)      # noqa: E731
            y = checkpoint(layer, x, use_reentrant=False) if remat \
                else layer(x)
            y.sum().backward()
        return op_cost.count(f, torch.ones(n, n))

    plain, remat = step(False), step(True)
    mm = 2 * n ** 3
    # forward 1 matmul, backward 1 (dW; x needs no gradient); the
    # recompute: the matmul and its elementwise ops again
    assert plain.flops >= 2 * mm
    assert mm + n * n <= remat.flops - plain.flops <= mm + 2 * n * n


def test_peak_bytes_of_the_call_own_storages():
    n = 1 << 12

    def f(x):
        a = x + 1
        b = a * 2
        return b.sum()

    cost = op_cost.count(f, torch.ones(n))
    assert 2 * n * 4 <= cost.peak_bytes <= 2 * n * 4 + 64


@pytest.fixture
def fake_world():
    """A fake process group of 4 ranks (rank 0), ended after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_by_kind_on_a_fake_mesh(fake_world):
    """spmd's all-gather (FSDP's too), all-reduce, reduce-scatter,
    broadcast and exchange on a fake (2, 2) mesh: the reference's sizes
    (an all-gather its gathered result, an all-reduce its result, a
    reduce-scatter its input) and counts by kind."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import spmd as S
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    mc = S.MeshCtx(mesh)
    with FakeTensorMode():
        t = torch.empty(8, 16)
        nb = 8 * 16 * 4
        with op_cost.counting() as cost:
            S.all_gather(t, mc.model_group, 0)
            S.fsdp_gather(t, 1, mc)
            S.all_reduce(t, mc.data_group)
            S.reduce_scatter(t, mc.model_group, 0)
            S.broadcast(t, 0, mc.model_group)
            S.exchange(t, 1, t, 1, mc.model_group)
    assert cost.coll_by_kind == {"all-gather": 2 * 2 * nb,
                                 "all-reduce": nb, "reduce-scatter": nb,
                                 "collective-broadcast": nb,
                                 "collective-permute": nb}
    assert cost.coll_count == {"all-gather": 2, "all-reduce": 1,
                               "reduce-scatter": 1,
                               "collective-broadcast": 1,
                               "collective-permute": 1}
    assert cost.coll_bytes == sum(cost.coll_by_kind.values())
    stats = RA.collective_stats(cost)
    assert stats.bytes_by_kind["all-to-all"] == 0
    assert stats.count_by_kind["all-gather"] == 2


def _fake_call(kernel):
    """(the adapter's call on fake bf16 inputs, its kernel's shape dict,
    the cost's extra arguments, the wrapper)."""
    b, s, h, kv, d = 2, 64, 4, 2, 32
    bf = torch.bfloat16
    if kernel == "flash_attention":
        q, k, v = (torch.empty(b, s, n, d, dtype=bf) for n in (h, kv, kv))
        return (lambda: ops.flash_attention(q, k, v),
                {"b": b, "s": s, "h": h, "kv": kv, "d": d,
                 "dtype": "bfloat16"}, {}, fa.flash_attention_bhsd)
    if kernel == "decode_attention":
        q = torch.empty(b, 1, h, d, dtype=bf)
        kc, vc = (torch.empty(b, s, kv, d, dtype=bf) for _ in range(2))
        clen = torch.empty(b, dtype=torch.int32)
        return (lambda: ops.decode_attention(q, kc, vc, clen),
                {"b": b, "s": s, "h": h, "kv": kv, "d": d,
                 "dtype": "bfloat16"}, {"valid": b * s},
                dec.decode_attention_bhd)
    if kernel == "rwkv6":
        r, k, v = (torch.empty(b, s, h, d, dtype=bf) for _ in range(3))
        logw, u = torch.empty(b, s, h, d), torch.empty(h, d)
        return (lambda: ops.wkv6(r, k, v, logw, u),
                {"b": b, "s": s, "h": h, "k": d, "dtype": "bfloat16"}, {},
                wkv.wkv6_bhsk)
    x = torch.empty(b, s, h, d, dtype=bf)
    dt, A, D = torch.empty(b, s, h), torch.empty(h), torch.empty(h)
    Bm, Cm = (torch.empty(b, s, 1, 16, dtype=bf) for _ in range(2))
    return (lambda: ops.mamba2_ssd(x, dt, A, Bm, Cm, D),
            {"b": b, "s": s, "h": h, "p": d, "n": 16, "g": 1,
             "dtype": "bfloat16"}, {}, ssd.ssd_bhsp)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_a_fake_kernel_call_is_recorded_at_its_kernelspec_cost(kernel):
    with FakeTensorMode():
        call, shape, kw, wrapper = _fake_call(kernel)
        before = wrapper.launches
        with op_cost.counting() as cost:
            out = call()
    flops, nbytes = KERNELS[kernel].cost(shape, **kw)
    assert cost.kernels == [{"name": kernel, "shape": shape,
                             "flops": flops, "bytes": nbytes}]
    assert cost.flops == flops and cost.bytes == cost.bytes_fused == nbytes
    assert cost.kernel_tally() == {kernel: {"launches": 1, "flops": flops,
                                            "bytes": nbytes}}
    assert wrapper.launches == before           # nothing launched
    assert out.dtype == torch.bfloat16 and out.shape[0] == 2


def test_the_fake_decode_with_lse_returns_the_partial_softmax():
    with FakeTensorMode():
        q = torch.empty(2, 1, 4, 32, dtype=torch.bfloat16)
        kc = torch.empty(2, 64, 2, 32, dtype=torch.bfloat16)
        with op_cost.counting() as cost:
            o, lse = ops.decode_attention(q, kc, kc, torch.empty(
                2, dtype=torch.int32), return_lse=True)
    assert (o.dtype, tuple(o.shape)) == (torch.float32, (2, 1, 4, 32))
    assert (lse.dtype, tuple(lse.shape)) == (torch.float32, (2, 4))
    assert len(cost.kernels) == 1


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_a_fake_tensor_outside_a_count_raises(kernel):
    with FakeTensorMode():
        call, _, _, wrapper = _fake_call(kernel)
        before = wrapper.launches
        with pytest.raises(RuntimeError, match="outside a count"):
            call()
    assert wrapper.launches == before


def test_a_real_tensor_takes_the_plain_version_under_a_count():
    q = torch.randn(1, 16, 2, 8)
    before = fa.flash_attention_bhsd.launches
    with op_cost.counting() as cost:
        o = ops.flash_attention(q, q, q)
    assert torch.isfinite(o).all() and not cost.kernels
    assert cost.flops > 0
    assert fa.flash_attention_bhsd.launches == before


def test_roofline_terms_and_dominant():
    r = RA.Roofline(flops_per_device=989e12, bytes_per_device=3.35e12 * 2,
                    collective_bytes=450e9 * 0.5,
                    collectives=RA.CollectiveStats({}, {}),
                    model_flops=989e12 * 128, n_chips=256)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.dominant == "memory"
    assert r.step_time_s == pytest.approx(2.0)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(128 / (256 * 2.0))


def test_the_constants_are_the_priors_and_the_keys_the_references():
    assert (RA.PEAK_FLOPS, RA.HBM_BW, RA.ICI_BW) == (
        PR.H100.peak_flops, PR.H100.hbm_bw, PR.H100.ici_bw)
    ref = REF_RA.Roofline(1.0, 1.0, 1.0, REF_RA.CollectiveStats({}, {}),
                          1.0, 1).as_dict()
    got = RA.Roofline(1.0, 1.0, 1.0, RA.CollectiveStats({}, {}), 1.0,
                      1).as_dict()
    renamed = {"xla_cost_analysis_reference": "fused_program_reference"}
    assert {renamed.get(k, k) for k in ref} <= set(got)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_the_reference(arch, shape):
    assert RA.model_flops(get_arch(arch), SHAPES[shape]) == \
        REF_RA.model_flops(ref_arch(arch), REF_SHAPES[shape])


def test_register_count_estimates_analyze_step_time():
    cost = op_cost.Cost(flops=3e12, bytes=7e9, bytes_fused=1e9,
                        coll_bytes=9e9, coll_by_kind={"all-reduce": 9e9},
                        coll_count={"all-reduce": 2})
    cfg, shape = get_arch("olmo-1b"), SHAPES["train_4k"]
    roof = RA.analyze(cost, cfg, shape, 256)
    prior = PR.RooflinePrior({"h100": PR.H100}).register_count("t", cost)
    assert prior.estimate("t", "h100", {"chips": 1}) == \
        pytest.approx(roof.step_time_s)
    assert roof.dominant == "collective"
    steps = PR.RooflinePrior({"h100": PR.H100}).register_count(
        "t", cost, scale_by="steps")
    assert steps.estimate("t", "h100", {"chips": 1, "steps": 5}) == \
        pytest.approx(5 * roof.step_time_s)
    tc = PR.TemplateCost.from_count(cost)
    assert tc.evaluate({}) == (3e12, 7e9, 9e9)
    with pytest.raises(NotImplementedError, match="from_count"):
        PR.TemplateCost.from_hlo("HloModule m")
    with pytest.raises(NotImplementedError, match="register_count"):
        PR.RooflinePrior({"h100": PR.H100}).register_hlo("t", "HloModule m")
    assert math.isclose(roof.memory_s, 7e9 / PR.H100.hbm_bw)
