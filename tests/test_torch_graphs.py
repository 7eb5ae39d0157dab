"""The port's many-steps-a-dispatch paths (``utils/graphs.py``, the JAX
package's ``lax.scan``/``fori_loop`` dispatch) on the CPU, where they run
their steps eagerly, the plain version of the replayed CUDA graph:

- ``train_chunk`` and ``epoch_step`` bit-equal to the same ``train_step``
  calls (TINY, f64 and ``--bf16-params``), the generator left in the same
  state;
- ``adam_update_at`` (a device step counter and a table of bias
  corrections) bit-equal to ``adam_update``, and against JAX's
  ``adam_update`` for steps 1–40 (f64);
- ``ddpm_update`` on device tables and ``sample`` against JAX's sampler
  body (f64 forward, the same initial noise and z);
- ``train``'s dispatch: which path each flag combination takes, JAX's
  ``SystemExit`` messages, and the paths' train states bit-equal;
- mnist_nn's ``ResidentEpoch`` bit-equal to the eager epoch and against
  JAX's ``epoch_step_resident`` (f64);
- ``Config.scan_unroll`` and ``--scan-unroll`` as in the JAX package;
- ``StepGraph``'s launch counters and its split of a run into eager steps
  and replays.

On the card ``chip_smoke.py``'s phase 27 (``tools/graph_check.py``) holds
the replays bit-equal to the eager steps.
"""

import contextlib
import dataclasses
import inspect
import shutil

import numpy as np
import pytest
import torch

try:  # JAX is absent where the card is: there only the card cases run
    import jax
    import jax.numpy as jnp

    from big_linear_algebra_tpu.models import cifar_unet as jax_cu
    from big_linear_algebra_tpu.models import mnist_nn as jax_nn
    from big_linear_algebra_tpu.nn import optim as jax_optim
except ImportError:
    jax = jnp = jax_cu = jax_nn = jax_optim = None
from big_linear_algebra_tpu_torch.data import synth
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.models import mnist_nn
from big_linear_algebra_tpu_torch.nn import optim
from big_linear_algebra_tpu_torch.nn.optim import adam_init, tree_leaves
from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.ops import matmul as mm
from big_linear_algebra_tpu_torch.utils import debug, graphs
from tests.torch_parity import card, n, t

F64 = dataclasses.replace(cu.TINY, compute_dtype="float64")
BF16_PARAMS = dataclasses.replace(cu.TINY, param_dtype="bfloat16")


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return tree_leaves(tree)


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _unet_case(cfg, n_examples=12, device="cpu"):
    p = cu.cast_params(cu.init_params(torch.Generator().manual_seed(0),
                                      cu.TINY), cfg)
    dt = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    data = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (n_examples, 3, 32, 32))).to(dt)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(n_examples))
    return (cu.tree_map(lambda a: a.to(device), p), data.to(device),
            perm.to(device))


def _eager_steps(cfg, p, data, rows, seed):
    gen = torch.Generator(data.device).manual_seed(seed)
    opt, losses = adam_init(p), []
    for r in rows:
        p, opt, loss = cu.train_step(p, opt, cu._fit_images(data[r], cfg),
                                     gen, cfg)
        losses.append(loss)
    return p, opt, torch.stack(losses), gen.get_state()


@pytest.mark.parametrize("cfg, on_card", [
    (F64, False), (BF16_PARAMS, False),
    pytest.param(cu.TINY, True, marks=pytest.mark.card)],
    ids=["f64", "bf16-params", "f32-card"])
def test_epoch_step_and_train_chunk_equal_train_steps(cfg, on_card):
    """A whole epoch (6 steps, graphs of 4: one warm-up step on the card)
    and a chunk of 3 steps against the same ``train_step`` calls: every
    parameter, both moments, the losses and the generator's state bit for
    bit, and the Adam step count. The steps' Adam is the in-place pass
    (``adam_update_at_``, its launches counted, the replays' too) for f32
    on the card and ``adam_update_at`` elsewhere (f64 and
    ``--bf16-params``' stochastic rounding on the CPU: no launch)."""
    device = card() if on_card else torch.device("cpu")
    p, data, perm = _unet_case(cfg, device=device)
    rows = perm.reshape(6, 2)
    want = _eager_steps(cfg, p, data, rows, seed=3)
    gen = torch.Generator(device).manual_seed(3)
    launches = optim.adam_launch_count
    params, opt, losses = cu.epoch_step(p, adam_init(p), data, perm, gen, cfg)
    per_step = 0
    if on_card:
        lib = cuda_utils.load_library("adam")
        per_step = -(-len(tree_leaves(p)) // lib.bla_adam_leaves_per_launch())
    assert optim.adam_launch_count - launches == 6 * per_step
    _assert_trees_equal(params, want[0])
    _assert_trees_equal((opt.m, opt.v), (want[1].m, want[1].v))
    assert opt.step == want[1].step == 6
    assert torch.equal(losses, want[2])
    assert torch.equal(gen.get_state(), want[3])

    want = _eager_steps(cfg, p, data, rows[:3], seed=4)
    gen = torch.Generator(device).manual_seed(4)
    params, opt, losses = cu.train_chunk(p, adam_init(p), data, rows[:3],
                                         gen, cfg)
    _assert_trees_equal(params, want[0])
    _assert_trees_equal((opt.m, opt.v), (want[1].m, want[1].v))
    assert opt.step == 3 and torch.equal(losses, want[2])
    assert torch.equal(gen.get_state(), want[3])


def test_train_steps_continue_across_runs():
    """One ``TrainSteps`` over two runs (an epoch, then another with a
    shorter order) is the same steps in a row: its Adam step count and bias
    corrections continue."""
    cfg = F64
    p, data, perm = _unet_case(cfg)
    steps = cu.TrainSteps(p, adam_init(p), data,
                          torch.Generator().manual_seed(5), cfg, unroll=2)
    steps.run(perm.reshape(6, 2))
    steps.run(perm[:6].reshape(3, 2))
    rows = torch.cat([perm.reshape(6, 2), perm[:6].reshape(3, 2)])
    want = _eager_steps(cfg, p, data, rows, seed=5)
    _assert_trees_equal(steps.params, want[0])
    _assert_trees_equal((steps.m, steps.v), (want[1].m, want[1].v))
    assert steps.step == 9


def _tree(rng, dtype):
    return {"a": rng.standard_normal((3, 4)).astype(dtype),
            "b": {"c": rng.standard_normal(5).astype(dtype)}}


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_adam_update_at_equals_int_form_and_jax(rng, dtype):
    """40 steps: ``adam_update_at`` (the step's row of a table of bias
    corrections, read by a device counter) against ``adam_update``, bit
    for bit (bf16 parameters with stochastic rounding too), and the f64
    steps against JAX's ``adam_update`` (1e-12: the tables equal JAX's f32
    bias corrections bit for bit at these steps)."""
    grads = [_tree(rng, np.float64) for _ in range(40)]
    p0 = _tree(rng, np.float64)
    dt = getattr(torch, dtype)
    p_int = p_at = cu.tree_map(lambda a: a.to(dt), cu.params_from_jax(p0))
    s_int = s_at = adam_init(p_int)
    table = optim.bias_corrections(1, 40)
    counter = torch.zeros((), dtype=torch.int64)
    seed = 1234 if dtype == "bfloat16" else None
    for g in grads:
        g = cu.tree_map(lambda a: a.to(dt), cu.params_from_jax(g))
        p_int, s_int = optim.adam_update(p_int, g, s_int, 2e-4,
                                         sr_seed=seed)
        p_at, s_at = optim.adam_update_at(p_at, g, s_at, counter, table,
                                          2e-4, sr_seed=seed)
        counter += 1
    _assert_trees_equal((p_at, s_at.m, s_at.v), (p_int, s_int.m, s_int.v))
    assert s_at.step == s_int.step == 40
    np.testing.assert_array_equal(
        n(table), np.stack([[1 - np.float32(0.9) ** np.float32(i),
                             1 - np.float32(0.999) ** np.float32(i)]
                            for i in range(1, 41)]).astype(np.float32))
    if dtype != "float64":
        return
    jp = jax.tree.map(jnp.asarray, p0)
    state = jax_optim.adam_init(jp)
    update = jax.jit(lambda p, g, s: jax_optim.adam_update(p, g, s, 2e-4))
    for g in grads:
        jp, state = update(jp, jax.tree.map(jnp.asarray, g), state)
    for got, want in ((p_at, jp), (s_at.m, state.m), (s_at.v, state.v)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            n(a), n(b), rtol=0, atol=1e-12), got, want)


def test_bias_corrections_equal_jax_f32():
    """The table's rows are JAX's f32 ``1 - b ** t`` bit for bit, steps
    1–200."""
    f = jax.jit(lambda s: jnp.stack([1 - 0.9 ** s, 1 - 0.999 ** s]))
    want = np.stack([np.asarray(f(jnp.float32(i))) for i in range(1, 201)])
    np.testing.assert_array_equal(optim.bias_corrections(1, 200).numpy(),
                                  want)


JAX_FORWARD = (jax.jit(jax_cu.forward, static_argnums=3)
               if jax is not None else None)


def test_sample_and_ddpm_update_match_jax_body(monkeypatch):
    """``sample`` (TINY, f64 forward, 8 steps), each denoising step held to
    JAX's loop body at the port's x: ε within 1e-6 of JAX's f64 forward
    (both cast to f32, as JAX's ``sample`` does), the device-table
    ``ddpm_update`` within 1e-6 of the body's f32 arithmetic on the same x,
    ε and z, the timesteps T−1 … 0, the initial noise and z the generator's
    draws in order, and the image the last step's x clipped."""
    records = []
    real = cu.ddpm_update

    def spy(x, eps, step, z, schedule):
        out = real(x, eps, step, z, schedule)
        records.append([a.clone() for a in (x, eps, step, z, out)])
        return out

    monkeypatch.setattr(cu, "ddpm_update", spy)
    params = cu.init_params(torch.Generator().manual_seed(0), cu.TINY)
    got = cu.sample(params, torch.Generator().manual_seed(5), F64, 2)
    gen = torch.Generator().manual_seed(5)
    shape = (2, 3, 32, 32)
    assert torch.equal(records[0][0], torch.randn(shape, generator=gen))
    betas, alphas, alpha_bars = jax_cu.ddpm_schedule(jax_cu.TINY)
    jcfg = dataclasses.replace(jax_cu.TINY, compute_dtype="float64")
    jp = jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, params))
    assert [int(r[2]) for r in records] == list(range(F64.timesteps))[::-1]
    for x, eps, step, z, out in records:
        assert torch.equal(z, torch.randn(shape, generator=gen))
        step = int(step)
        want_eps = np.asarray(JAX_FORWARD(
            jp, jnp.asarray(n(x)), jnp.full((2,), step, jnp.int32), jcfg)
        ).astype(np.float32)
        np.testing.assert_allclose(n(eps), want_eps, rtol=1e-6, atol=1e-6)
        beta, alpha, ab = betas[step], alphas[step], alpha_bars[step]
        mean = (jnp.asarray(x.numpy()) - beta / jnp.sqrt(1.0 - ab)
                * jnp.asarray(eps.numpy())) / jnp.sqrt(alpha)
        want = jnp.where(step > 0, mean + jnp.sqrt(beta)
                         * jnp.asarray(z.numpy()), mean)
        np.testing.assert_allclose(n(out), n(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(got, records[-1][4].clamp(-1.0, 1.0))


def test_dispatch_messages_are_jax():
    """``--scan-steps>1`` under ``--dp`` and ``--pp`` exits with the JAX
    package's messages (read from its ``train``); alone and under ``--tp``
    (a graph of the TP step, JAX's GSPMD chunk) it is the chunk size."""
    src = inspect.getsource(jax_cu.train)
    for kind in ("dp", "pp"):
        with pytest.raises(SystemExit) as e:
            cu._scan_steps({"scan-steps": "2"}, kind)
        words = str(e.value).split()
        assert " ".join(words[:6]) in src and words[-1] in src
        assert all(w.strip('"()') in src for w in words), str(e.value)
    assert cu._scan_steps({"scan-steps": "2"}, "tp") == 2
    for kind in ("dp", "tp", "pp", "single"):
        assert cu._scan_steps({}, kind) == 1
        assert cu._scan_steps({"scan-steps": "1"}, kind) == 1
    assert cu._scan_steps({"scan-steps": "3"}, "single") == 3


@pytest.fixture
def tiny_cifar(tmp_path, monkeypatch):
    """A 10-example synthesized CIFAR set (5 TINY steps an epoch) and the
    TINY init's CSV tree, in ``tmp_path``."""
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    synth.ensure_cifar(str(tmp_path), n_batches=5, per_batch=2)
    assert cu.main(["init", "--tiny"]) == 0
    return tmp_path


def _spy_paths(monkeypatch):
    """Each ``TrainSteps.run`` (its unroll and row count) and each eager
    ``train_step`` call of a ``train``."""
    calls = []
    real_run, real_step = cu.TrainSteps.run, cu.train_step

    def run(self, idx):
        calls.append(("graph", self.graph.unroll, idx.shape[0]))
        return real_run(self, idx)

    def step(*a, **k):
        calls.append(("step",))
        return real_step(*a, **k)

    monkeypatch.setattr(cu.TrainSteps, "run", run)
    monkeypatch.setattr(cu, "train_step", step)
    return calls


def _train_state():
    state = cu.ckpt_pytree.restore_pytree(
        cu.state_dir(), cu.ckpt_pytree.latest_step(cu.state_dir()))
    shutil.rmtree(cu.state_dir())
    return state


@pytest.mark.parametrize("flags, want", [
    ([], [("graph", 4, 5)]),
    (["--scan-unroll=2"], [("graph", 2, 5)]),
    (["--scan-steps=2"], [("graph", 2, 4), ("graph", 2, 1)]),
    (["--scan-steps=2", "--max-steps=3"], [("graph", 2, 2), ("graph", 2, 1)]),
    (["--host-loop"], [("step",)] * 5),
    (["--max-steps=3"], [("step",)] * 3),
    (["--dp"], [("graph", 4, 5)]),
], ids=["default", "unroll", "scan-steps", "scan-max", "host-loop",
        "max-steps", "dp-single"])
def test_train_dispatch_paths(tiny_cifar, monkeypatch, capsys, flags, want):
    """``train``'s path by the JAX package's rules (:1516-1630): the device
    epoch without ``--max-steps``, ``--scan-steps`` or ``--host-loop``
    (``--dp`` on one device runs unsharded, as there), K steps a replay
    under ``--scan-steps=K`` with the ragged tail step by step, and one
    eager step per batch otherwise; each path's train state equal bit for
    bit to ``--host-loop``'s over the same steps (parameters, moments,
    generator)."""
    calls = _spy_paths(monkeypatch)
    assert cu.main(["train", "1", "--tiny", "--device=cpu", *flags]) == 0
    assert calls == want
    got = _train_state()
    limit = [f for f in flags if f.startswith("--max-steps")]
    assert cu.main(["init", "--tiny"]) == 0  # train wrote its CSV tree
    assert cu.main(["train", "1", "--tiny", "--device=cpu", "--host-loop",
                    *limit]) == 0
    ref = _train_state()
    _assert_trees_equal((got["params"], got["opt"]["m"], got["opt"]["v"]),
                        (ref["params"], ref["opt"]["m"], ref["opt"]["v"]))
    assert got["opt"]["step"] == ref["opt"]["step"] == len(
        [c for c in want if c[0] == "step"]) + sum(
            c[2] for c in want if c[0] == "graph")
    assert torch.equal(got["rng"], ref["rng"])
    capsys.readouterr()


def test_train_without_residency_streams(tiny_cifar, monkeypatch, capsys):
    """A dataset past ``_RESIDENT_BYTES``: the default epoch takes the
    eager steps (the JAX package's 2 GiB rule), and ``--scan-steps=2``
    stages each chunk in a device buffer, one ``TrainSteps.run`` a chunk;
    its train state equal bit for bit to ``--host-loop``'s (both
    streamed)."""
    monkeypatch.setattr(cu, "_RESIDENT_BYTES", 0)
    calls = _spy_paths(monkeypatch)
    assert cu.main(["train", "1", "--tiny", "--device=cpu"]) == 0
    assert calls == [("step",)] * 5
    _train_state()
    calls.clear()
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["train", "1", "--tiny", "--device=cpu",
                    "--scan-steps=2"]) == 0
    assert calls == [("graph", 2, 2), ("graph", 2, 2), ("graph", 2, 1)]
    got = _train_state()
    assert cu.main(["init", "--tiny"]) == 0
    assert cu.main(["train", "1", "--tiny", "--device=cpu",
                    "--host-loop"]) == 0
    ref = _train_state()
    _assert_trees_equal((got["params"], got["opt"]["m"], got["opt"]["v"]),
                        (ref["params"], ref["opt"]["m"], ref["opt"]["v"]))
    assert torch.equal(got["rng"], ref["rng"])
    capsys.readouterr()


def test_debug_modes_select_eager_steps():
    """Under ``debug_nans`` and ``no_jit`` no step is captured: a
    ``StepGraph`` on a CUDA device is then not graphed (the check runs
    between two ops); outside them it is, and on the CPU never."""
    cuda = torch.device("cuda")
    assert graphs.graphs_allowed(cuda)
    assert not graphs.graphs_allowed(torch.device("cpu"))
    for mode in (debug.debug_nans, debug.no_jit):
        with mode():
            assert debug.active() and not graphs.graphs_allowed(cuda)
            assert not graphs.StepGraph(4, cuda).graphed
    assert not debug.active()


def test_step_graph_counters_and_split(monkeypatch):
    """``StepGraph.run``'s split of k steps (warm-up, capture, replays)
    and its launch counters, with the capture and the replay stood in for:
    a capture takes back the launches it records, and each replay adds
    them again, so a run counts what its eager steps would."""
    log = []

    def step():
        mm.launch_count += 5
        mm.variant_launch_counts["nn"] += 2
        log.append("step")

    class FakeGraph:
        def replay(self):
            log.append("replay")

    g = graphs.StepGraph(4, torch.device("cpu"), graphed=False)
    g.graphed = True
    monkeypatch.setattr(g, "_on_capture_stream", contextlib.nullcontext)

    def capture(step):
        before = graphs.launch_counts()
        for _ in range(g.unroll):
            step()
        after = graphs.launch_counts()
        graphs._set_counts(before)
        g.deltas = {k: after[k] - v for k, v in before.items()
                    if after[k] != v}
        g.graph = FakeGraph()
        log.append("capture")

    monkeypatch.setattr(g, "capture", capture)
    mm.launch_count, nn0 = 0, mm.variant_launch_counts["nn"]
    g.run(3, step)  # fewer than unroll: eager, no capture
    g.run(10, step)  # warm-up of 1 + 9 % 4 = 2 steps, capture, 2 replays
    g.run(6, step)  # 6 % 4 = 2 eager, 1 replay
    assert log == ["step"] * 3 + ["step"] * 2 + ["step"] * 4 + ["capture"] \
        + ["replay"] * 2 + ["step"] * 2 + ["replay"]
    assert mm.launch_count == 5 * 19
    assert mm.variant_launch_counts["nn"] - nn0 == 2 * 19
    mm.variant_launch_counts["nn"] = nn0
    mm.launch_count = 0


def test_mnist_resident_epoch_equals_eager_epoch_and_jax(rng):
    """mnist_nn's ``ResidentEpoch`` (a static index buffer read by a device
    counter, static accumulators, the perm padded with −1) on a ragged
    200-example epoch at batch 64: bit-equal to the eager epoch (one
    ``train_step`` per row of ``_resident_batches``) in f32, and, in f64,
    within 1e-10 of JAX's ``epoch_step_resident``; run twice on one object
    (two epochs) equal to two eager epochs."""
    jp = {k: np.asarray(v, np.float64)
          for k, v in jax_nn.init_params(jax.random.key(5)).items()}
    x_raw = rng.integers(0, 256, (200, 784)).astype(np.float32)
    y = rng.integers(0, 10, 200).astype(np.float32)
    perm = mnist_nn.epoch_permutation(np.random.default_rng(7), 200, 64)
    cfg = dataclasses.replace(mnist_nn.CONFIG, scan_unroll=3)

    def model(dtype):
        return mnist_nn.MnistNN.from_params(mnist_nn.params_from_jax(jp),
                                            dtype=dtype)

    eager = model(torch.float32)
    metrics = []
    for _ in range(2):
        c_sum = ce_sum = 0.0
        for batch in mnist_nn._resident_batches(
                t(x_raw), t(y), t(perm).long().reshape(-1, 64), cfg):
            c, ce = mnist_nn.train_step(eager, *batch, cfg)
            c_sum, ce_sum = c_sum + c, ce_sum + ce
        metrics.append((c_sum, ce_sum))
    graphed = model(torch.float32)
    epoch = mnist_nn.ResidentEpoch(graphed, t(x_raw), t(y), cfg)
    got = [epoch(t(perm)) for _ in range(2)]
    for k, v in graphed.params().items():
        assert torch.equal(v, eager.params()[k]), k
    for (c, ce), (wc, wce) in zip(got, metrics):
        assert torch.equal(c, wc) and torch.equal(ce, wce)

    m64 = model(torch.float64)
    got_c, got_ce = mnist_nn.ResidentEpoch(
        m64, t(x_raw).double(), t(y), cfg)(t(perm))
    want, want_c, want_ce = jax_nn.epoch_step_resident(
        {k: jnp.asarray(v) for k, v in jp.items()},
        jnp.asarray(x_raw, jnp.float64), jnp.asarray(y), jnp.asarray(perm))
    for k, v in m64.params().items():
        np.testing.assert_allclose(n(v), n(want[k]), rtol=0, atol=1e-10,
                                   err_msg=k)
    assert int(got_c) == int(want_c)
    np.testing.assert_allclose(float(got_ce), float(want_ce), rtol=1e-10)


def test_scan_unroll_from_both_sides(capsys):
    """``scan_unroll`` defaults to the JAX package's in both programs, and
    ``--scan-unroll=U`` sets it as there; ``run`` takes none of the
    dispatch flags (they apply to train)."""
    assert cu.Config().scan_unroll == jax_cu.Config().scan_unroll == 4
    assert mnist_nn.Config().scan_unroll == jax_nn.Config().scan_unroll == 4
    flags = {"scan-unroll": "2", "tiny": ""}
    assert (cu._cfg_from_flags(flags).scan_unroll
            == jax_cu._cfg_from_flags(flags).scan_unroll == 2)
    with pytest.raises(ValueError, match="must be positive"):
        cu._cfg_from_flags({"scan-unroll": "0"})
    for main, flag in ((cu.main, "--scan-steps=2"), (cu.main, "--host-loop"),
                       (cu.main, "--scan-unroll=2"),
                       (mnist_nn.main, "--scan-unroll=2")):
        assert main(["run", "1", flag]) == 1
        assert "applies to train" in capsys.readouterr().out
