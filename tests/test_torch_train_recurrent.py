"""Training the recurrent families against ``repro.train`` on the CPU:
the port's differentiable scans (``rwkv.wkv6_chunked``,
``mamba.ssd_chunked``) against autograd through the sequential oracles, and
reduced rwkv6-7b and zamba2-7b (the hybrid with and without a trailing
layer) against ``jax.value_and_grad`` and the reference's train step.
Inputs from seeded numpy, passed as numpy arrays; the leaves the reference
initialises to zero are seeded in both packages' params, so that every
gradient path carries a value."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch as port_arch  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import mamba as MB  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import train_step as T  # noqa: E402

CPU = "cpu"
# "zamba2-7b@7": one period of 5 Mamba-2 layers and the shared block, then
# one trailing Mamba-2 layer; the reduced zamba2-7b (6 layers) has two
# periods and its placeholder trailing layer, which never runs
CONFIGS = ["rwkv6-7b", "zamba2-7b", "zamba2-7b@7"]
# the leaves the reference initialises to zero, and the scale of the seeded
# values given them here (chip_smoke.py's _enliven_rwkv's; Mamba's conv
# biases as a Mamba-2 checkpoint would have them)
SEEDED = {"bonus_u": 0.1, "shift_lora_b": 0.01, "decay_lora_b": 0.01,
          "conv_b_x": 0.1, "conv_b_BC": 0.1}
# fp32 gradients, each leaf against its largest entry. zamba2-7b holds
# tests/test_torch_train.py's GRAD_TOL (measured within 0.14 of it).
# rwkv6-7b's per-head group norm divides each head's WKV output by its
# standard deviation, which at the first tokens is about 2e-3 against
# outputs up to 1e2, so the scans' fp32 rounding (2e-7 of the largest
# output, in both packages) reaches the gradients as about 5e-5 of each
# leaf's largest entry: the port's own sequential oracle in place of its
# chunked scan moves them 4.4e-5, and the reference is as far from either
# (measured at most 5.5e-5). rwkv6-7b is held to 2e-4 of the leaf max.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
RWKV_GRAD_ATOL = 2e-4
# AdamW's moments after 3 steps: rwkv6-7b's gradient noise, and the later
# gradients of params whose first updates flipped sign, put its moments up
# to 1.3 GRAD_TOL from the reference's (measured); they are held to
# rtol 1e-4 and atol 3e-5. zamba2-7b's hold GRAD_TOL.
RWKV_MOMENT_TOL = dict(rtol=1e-4, atol=3e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for torch while each test runs: every tensor here
    is small, and under several pytest-xdist workers each worker's thread
    pool oversubscribed the cores (a 601-token sequential oracle took over
    100 s in place of 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(name):
    arch, _, layers = name.partition("@")
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
        tcfg = dataclasses.replace(tcfg, n_layers=int(layers))
    return cfg, tcfg


def _seeded(tree, rng):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _seeded(val, rng)
        elif key in SEEDED:
            out[key] = (SEEDED[key] * rng.standard_normal(val.shape)).astype(
                np.float32)
        else:
            out[key] = np.asarray(val)
    return out


def _params(name):
    """Reduced config in both packages and the reference's params (numpy),
    the zero-init leaves seeded."""
    cfg, tcfg = _cfgs(name)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, _seeded(params, np.random.default_rng(1))


def _batch(seed, b, s, vocab, ignore=0.2):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < ignore] = -100
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": labels}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat_np(tree):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          np.float32)
            for k, v in convert.flatten(tree).items()}


def _assert_grads_close(name, got, want, moments=False):
    got, want = _flat_np(got), _flat_np(want)
    assert list(got) == list(want)
    for key, w in want.items():
        tol = GRAD_TOL
        if name.startswith("rwkv"):
            tol = RWKV_MOMENT_TOL if moments else dict(
                rtol=1e-4, atol=RWKV_GRAD_ATOL * np.abs(w).max(initial=0))
        np.testing.assert_allclose(got[key], w, err_msg=key, **tol)


def _loss_and_grads(name, b, s, compute_dtype="float32", seed=0, **tkw):
    cfg, tcfg, params = _params(name)
    batch = _batch(seed, b, s, cfg.vocab_size)
    jtc = JT.TrainConfig(remat="none", compute_dtype=compute_dtype, **tkw)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(cfg, jtc), has_aux=True))(_j(params), _j(batch))
    grad_fn = T.make_grad_fn(tcfg, T.TrainConfig(
        remat="none", compute_dtype=compute_dtype, **tkw), device=CPU)
    tl, tm, tg = grad_fn(convert.from_numpy(params), _t(batch))
    return (float(jl), jm, jax.tree.map(np.asarray, jg)), (float(tl), tm, tg)


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


def _wkv6_inputs(seed, s, logw=None, b=2, h=2, k=16):
    """float64 r, k, v, u and a cotangent; logw uniform in [-1, 0), or
    ``logw`` everywhere."""
    rng = np.random.default_rng(seed)
    r_, k_, v_, ct = (rng.standard_normal((b, s, h, k)) for _ in range(4))
    lw = -rng.random((b, s, h, k)) if logw is None \
        else np.full((b, s, h, k), logw)
    u = rng.standard_normal((h, k))
    return [r_, k_, v_, lw, u], ct


def _ssd_inputs(seed, s, dt=None, b=2, h=4, p=16, g=2, n=8):
    """float64 x, dt, A, B, C, D and a cotangent: dt in (0, 0.1) and A from
    -1 to -16, zamba2-7b's init ranges, so dt A reaches -1.6 a token; or
    dt and A of one value each with the product ``dt``."""
    rng = np.random.default_rng(seed)
    x, ct = (rng.standard_normal((b, s, h, p)) for _ in range(2))
    if dt is None:
        dts, A = 0.1 * rng.random((b, s, h)), -np.linspace(1.0, 16.0, h)
    else:
        dts, A = np.full((b, s, h), 0.1), np.full(h, dt / 0.1)
    B, C = (rng.standard_normal((b, s, g, n)) for _ in range(2))
    return [x, dts, A, B, C, rng.standard_normal(h)], ct


SCANS = {"wkv6": (_wkv6_inputs, R.wkv6_chunked, ref.wkv6_ref),
         "ssd": (_ssd_inputs, MB.ssd_chunked, ref.ssd_ref)}


def _vjp(fn, args, ct):
    """fn's output and the gradients of <output, ct> (zeros where an input
    does not reach the output, as logw at S = 1)."""
    ins = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in args]
    out = fn(*ins)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(ct),
                                allow_unused=True)
    return [out.detach()] + [torch.zeros_like(a) if g is None else g
                             for a, g in zip(ins, grads)]


def _assert_vjp_close(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all()), i
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, err_msg=i,
                                   atol=tol * float(w.abs().max()))


@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 64, 65, 601])
@pytest.mark.parametrize("scan", sorted(SCANS))
def test_scan_matches_sequential_oracle(scan, s):
    """Output and the gradients of every input against autograd through
    kernels/ref.py's sequential oracle, float64 inputs, at S around the
    sub-chunk of 16 and the chunk of 64 and a ragged 601. Both run fp32
    inside, in other orders: each within 2e-5 of its largest entry
    (measured at most 4.2e-6)."""
    make, chunked, oracle = SCANS[scan]
    args, ct = make(s, s)
    _assert_vjp_close(_vjp(chunked, args, ct), _vjp(oracle, args, ct), 2e-5)


@pytest.mark.parametrize("s", [512, 601])
@pytest.mark.parametrize("scan", sorted(SCANS))
def test_scan_stays_finite_where_the_reference_breaks(scan, s):
    """logw -1 (WKV6) and dt A -1.6 (SSD) a token, at the full configs'
    chunk of 256: the reference's half-shifted factors overflow fp32 and
    its mask gives inf * 0 (non-finite at S = 512), and its reshape fails
    at S = 601. The port's output and gradients are finite and match the
    sequential oracle (2e-5 of each one's largest entry)."""
    make, chunked, oracle = SCANS[scan]
    args, ct = make(s, s, -1.0 if scan == "wkv6" else -1.6)
    jargs = [jnp.asarray(a, jnp.float32) for a in args]
    jfn = (JR.wkv6_chunked if scan == "wkv6" else JMB.ssd_chunked)
    if s % 256:
        with pytest.raises(TypeError, match="reshape"):
            jfn(*jargs, chunk=256)
    else:
        assert not np.isfinite(np.asarray(jfn(*jargs, chunk=256))).all()
    _assert_vjp_close(_vjp(chunked, args, ct), _vjp(oracle, args, ct), 2e-5)


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_scan_keeps_the_compute_dtype(scan):
    """bf16 activations in, bf16 out, fp32 inside: the output is the fp32
    scan's, rounded once."""
    make, chunked, _ = SCANS[scan]
    args, _ = make(7, 40)
    f32 = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    low = [a.bfloat16() if i in ((0, 1, 2) if scan == "wkv6" else (0, 3, 4))
           else a for i, a in enumerate(f32)]
    got = chunked(*low)
    assert got.dtype == torch.bfloat16
    want = chunked(*[a.float() for a in low])
    assert torch.equal(got, want.bfloat16())


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s", [(2, 32), (2, 40)])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_grads_match_jax(name, b, s):
    """fp32 loss within 1e-6 relative and every gradient leaf within the
    stated tolerance of ``jax.value_and_grad`` of the reference's loss, a
    fifth of the labels -100. S = 40 is no multiple of the port's 16 or
    64; the reference takes it as two chunks of 20."""
    (jl, jm, jg), (tl, tm, tg) = _loss_and_grads(name, b, s)
    assert tl == pytest.approx(jl, rel=1e-6)
    assert int(tm["ntokens"]) == int(jm["ntokens"]) < b * s
    _assert_grads_close(name, tg, jg)


@pytest.mark.parametrize("name", ["zamba2-7b", "zamba2-7b@7"])
def test_unused_trailing_layer_gets_zero_grads(name):
    """The hybrid keeps a placeholder trailing layer when no layer trails:
    ``jax.grad`` gives it zeros, and so does the port, which names it from
    the layout. With a trailing layer, it runs and gets gradients."""
    cfg, tcfg = _cfgs(name)
    trailing = TF.build_layout(tcfg)["trailing"]
    assert TF.unused_subtrees(tcfg) == (() if trailing else
                                        ("layers/trailing",))
    (_, _, jg), (_, _, tg) = _loss_and_grads(name, 1, 24)
    for key, g in _flat_np(tg).items():
        if key.startswith("layers/trailing/"):
            if trailing:
                assert g.any(), key
            else:
                assert not g.any(), key
                assert not convert.flatten(jg)[key].any(), key


def test_rwkv_and_dense_layouts_leave_nothing_unused():
    for arch in ("rwkv6-7b", "olmo-1b", "zamba2-7b"):
        assert TF.unused_subtrees(port_arch(arch)) == ()


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-7b@7"])
def test_bf16_loss_matches_jax(name):
    """bf16 compute: both packages round activations to 8 bits of mantissa
    at places that differ, and the recurrent families carry that rounding
    through their scans (ROADMAP C). Over 12 batches at S = 32 and 40, the
    reference's own bf16 loss sat up to 5.3e-3 (rwkv6-7b) and 1.1e-3
    (zamba2-7b) from its fp32 loss, relative, and the port's up to 3.5e-3
    and 8.4e-4. Each bf16 loss is held within 1e-2 (rwkv6-7b) or 3e-3
    (zamba2-7b) of the fp32 loss."""
    bound = 1e-2 if name.startswith("rwkv") else 3e-3
    for s in (32, 40):
        (fp32, _, _), _ = _loss_and_grads(name, 2, s)
        (jl, _, _), (tl, _, _) = _loss_and_grads(name, 2, s, "bfloat16")
        assert abs(jl - fp32) <= bound * abs(fp32)
        assert abs(tl - fp32) <= bound * abs(fp32)


def _run_both(name, steps, lr=1e-3, **tkw):
    """``steps`` train steps of both packages from the same params and the
    synthetic pipeline's batches (fp32 compute, weight decay 0.1)."""
    cfg, tcfg, params = _params(name)
    tkw = {"remat": "none", "compute_dtype": "float32", **tkw}
    okw = dict(lr=lr, warmup_steps=0, total_steps=100, weight_decay=0.1)
    jtc, ttc = JT.TrainConfig(**tkw), T.TrainConfig(**tkw)
    jstep = jax.jit(JT.make_train_step(cfg, jtc, JO.OptimizerConfig(**okw)))
    tstep = T.make_train_step(tcfg, ttc, O.OptimizerConfig(**okw),
                              device=CPU)
    jp, tp = _j(params), convert.from_numpy(params)
    js, ts = JT.make_opt_state(jp, jtc), T.make_opt_state(tp, ttc)
    pipe = JP.TokenPipeline(JP.DataConfig(vocab_size=32, seq_len=32,
                                          global_batch=4, markov_temp=2.5),
                            cfg)
    metrics = []
    for i in range(steps):
        batch = pipe.batch_at(i)
        jp, js, jm = jstep(jp, js, _j(batch))
        tp, ts, tm = tstep(tp, ts, batch)
        metrics.append((jm, tm))
    return params, jp, js, tp, ts, metrics


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches_reference_after_3_steps(name):
    """Params and optimizer state after 3 AdamW steps (lr 1e-3, weight
    decay 0.1 on leaves of rank >= 2), as tests/test_torch_train.py holds
    the dense family: params within 6 lr (a sign flip of an update of size
    lr per step where a gradient is near zero) and all but 1e-3 of their
    entries within 1e-5, counted over all leaves (rwkv6-7b's gradient noise,
    see RWKV_GRAD_ATOL, moved 35 of 224,576 entries by more, one of them in
    a leaf of 256); the moments at GRAD_TOL or RWKV_MOMENT_TOL. The
    weight decay reaches the stacked per-layer vectors of both families
    (decay_base, bonus_u, A_log, D, dt_bias, ...) and, in the hybrid
    without a trailing layer, the unused placeholder layer, whose moments
    stay zero: both packages alike (ROADMAP C)."""
    init, jp, js, tp, ts, metrics = _run_both(name, 3)
    for jm, tm in metrics:
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    got, want = _flat_np(tp), _flat_np(jax.tree.map(np.asarray, jp))
    before = _flat_np(init)
    far = 0
    for key, w in want.items():
        err = np.abs(got[key] - w)
        assert err.max(initial=0) <= 6e-3, key
        far += int((err > 1e-5).sum())
        if w.ndim >= 2 and w.size:             # decayed, if nothing else
            assert not np.array_equal(w, before[key]), key
    assert far <= 1e-3 * sum(w.size for w in want.values())
    for key in ("mu", "nu"):
        _assert_grads_close(name, ts[key], js[key], moments=True)
    assert int(ts["step"]) == int(js["step"]) == 3
    if name == "zamba2-7b":                 # the placeholder layer
        mu = _flat_np(ts["mu"])
        assert not any(mu[k].any() for k in mu
                       if k.startswith("layers/trailing/"))


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-7b@7"])
def test_remat_policies_give_equal_grads(name):
    """remat none, full and dots recompute the same ops on the same
    inputs: equal gradients within 1e-6 of each leaf's largest entry. The
    hybrid's shared block runs outside remat, as the reference's outer scan
    body does, and gathers the gradients of both its sites."""
    cfg, tcfg, params = _params(name)
    batch = _t(_batch(2, 2, 24, cfg.vocab_size))
    tp = convert.from_numpy(params)
    out = {}
    for remat in ("none", "full", "dots"):
        fn = T.make_grad_fn(tcfg, T.TrainConfig(
            remat=remat, compute_dtype="float32"), device=CPU)
        out[remat] = _flat_np(fn(tp, batch)[2])
    for remat in ("full", "dots"):
        for key, want in out["none"].items():
            np.testing.assert_allclose(
                out[remat][key], want, rtol=0, err_msg=f"{remat} {key}",
                atol=1e-6 * np.abs(want).max(initial=0))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_launch_train_main_on_cpu(arch, capsys, tmp_path):
    """The reduced recurrent configs train through launch/train.py's
    ``--arch`` (supervised, one checkpoint at the end)."""
    losses = LT.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                      "--seq-len", "16", "--global-batch", "4",
                      "--workdir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu: loss" in out
    assert out.strip().splitlines()[-1] == "done: 3 steps, 1 ckpts, latest=3"


@pytest.mark.parametrize("name,module,scan,cut", [
    ("zamba2-7b", MB, "ssd_chunked", "layers/inner/m/x_proj"),
    ("rwkv6-7b", R, "wkv6_chunked", "layers/tm/wr")])
def test_cut_graph_guard_names_a_detached_scan(name, module, scan, cut,
                                               monkeypatch):
    """A scan whose output has no grad_fn (as a kernel's would) cuts the
    projections before it off the loss: the step names them, and not the
    hybrid's unused trailing layer, whose zeros come from the layout."""
    real = getattr(module, scan)
    monkeypatch.setattr(module, scan, lambda *a: real(*a).detach())
    cfg, tcfg, params = _params(name)
    fn = T.make_grad_fn(tcfg, T.TrainConfig(remat="none"), device=CPU)
    with pytest.raises(RuntimeError, match=cut) as err:
        fn(convert.from_numpy(params), _t(_batch(0, 1, 8, cfg.vocab_size)))
    assert "layers/trailing" not in str(err.value)


def test_weight_decay_reaches_recurrent_vectors():
    """Zero gradients: only the decay moves a param. It follows the rank
    of the stacked leaves, as in the reference: RWKV's decay_base, bonus_u,
    mu and ln_x and Mamba's A_log, D, dt_bias and gate_norm are (L, .) or
    (P, I, .) and decay toward 0; the shared block's unstacked norms and
    final_norm do not."""
    cfg = O.OptimizerConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    decayed = {"rwkv6-7b": ("layers/tm/decay_base", "layers/tm/bonus_u",
                            "layers/tm/mu", "layers/tm/ln_x"),
               "zamba2-7b": ("layers/inner/m/A_log", "layers/inner/m/D",
                             "layers/inner/m/dt_bias",
                             "layers/inner/m/gate_norm",
                             "layers/trailing/m/A_log")}
    for arch, keys in decayed.items():
        _, _, params = _params(arch)
        tp = convert.from_numpy(params)
        zeros = O.tree_map(torch.zeros_like, tp)
        tp, _, _ = O.adamw_update(cfg, tp, zeros, O.init_opt_state(tp))
        new, old = convert.flatten(tp), convert.flatten(
            convert.from_numpy(params))
        for key in keys:
            assert torch.allclose(new[key], old[key] * (1 - 0.5e-2)), key
        for key in new:
            if key.startswith("shared_block/ln") or key.startswith(
                    "final_norm"):
                assert torch.equal(new[key], old[key]), key
