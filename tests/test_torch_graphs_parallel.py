"""The port's last one-dispatch loops on the CPU, with capture and replay
stood in for (``tests/torch_ranks.py`` ``stood_in_graphs``: the warm-up
eager, a capture that runs nothing, each replay the captured steps with
the counters advanced by the graph's counts), against the eager steps and
the JAX package:

- ``make_sgd_scan``'s static-buffer steps: bit-equal to T ``sgd_step``
  calls in f64 (T = 7, graphs of 2: a warm-up step and three replays), and
  within 1e-12 of JAX's ``make_sgd_scan``;
- mnist_hinge's ``Chunks`` (a whole chunk a graph, the ragged tail eager):
  bit-equal to the chunk loop as the port ran it (new tensors an
  iteration), with the convergence freeze inside a chunk, and within JAX's
  f64 tolerance of its ``_train_chunk``;
- on 2 gloo CPU ranks (one launch): mnist_nn's graphed DP epoch bit-equal
  to the eager DP epoch and within 1e-10 of JAX's
  ``make_epoch_resident_dp`` (f64); the hinge ``--dp`` chunks bit-equal to
  ``make_train_chunk_dp``'s; cifar_unet's DP epochs (TINY,
  ``--bf16-params``) bit-equal to the eager DP steps on the same two
  generators, the replicas bit-equal across ranks; the TP chunks
  (``--tp --scan-steps``) bit-equal to the eager TP steps; every case's
  collective counters equal graphed and eager; gloo's eager rule;
- ``eager_reason``'s rule (gloo, NCCL, the debug modes, ``eager()``), and a
  ``--dp`` train state of the earlier host-generator chain refused.

On the card ``chip_smoke.py``'s phase 28 and ``tools/graph_check.py
--ranks=4 --spawned`` hold the real replays bit-equal to the eager steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.models import mnist_hinge as jax_hinge
from big_linear_algebra_tpu.models import mnist_nn as jax_nn
from big_linear_algebra_tpu.nn import layer_graph as jax_lg
from big_linear_algebra_tpu.parallel import make_mesh as jax_make_mesh
from big_linear_algebra_tpu_torch.models import cifar_unet as cu
from big_linear_algebra_tpu_torch.models import mnist as port_mnist
from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
from big_linear_algebra_tpu_torch.models import mnist_nn
from big_linear_algebra_tpu_torch.models import my_first_model as port_mfm
from big_linear_algebra_tpu_torch.nn import layer_graph as lg
from big_linear_algebra_tpu_torch.nn.optim import adam_init
from big_linear_algebra_tpu_torch.utils import debug, graphs
from tests import torch_ranks
from tests.torch_parity import n, t


def _np_params(rng, sizes):
    return [(rng.standard_normal((o, i)) * 0.5, rng.standard_normal(o) * 0.1)
            for i, o in zip(sizes[:-1], sizes[1:])]


@pytest.mark.parametrize("sizes, acts", [
    ((2, 3, 2), port_mfm.ACTS),
    ((20, 8, 8, 10), port_mnist.ACTS),
], ids=["my_first_model", "mnist_narrow"])
def test_sgd_scan_graphed_equals_sgd_steps_and_jax(rng, sizes, acts):
    """T = 7 examples, graphs of 2: one warm-up step, a capture and three
    replays; the parameters and costs bit-equal to 7 ``sgd_step`` calls
    (each cost the pre-update squared error of its forward) in f64, and within 1e-12 of
    JAX's ``make_sgd_scan`` (its default unroll, 2)."""
    npp = _np_params(rng, sizes)
    xs = rng.standard_normal((7, sizes[0]))
    ys = rng.standard_normal((7, sizes[-1]))
    lr = 0.05
    p = lg.params_from_jax(npp)
    want_c = []
    for x, y in zip(t(xs), t(ys)):  # sgd_step, with the cost it logs
        p, c = lg._sgd_step_cost(p, acts, x, y, lr)
        want_c.append(c)
    with torch_ranks.stood_in_graphs() as log:
        got_p, got_c = lg.make_sgd_scan(acts, unroll=2)(
            lg.params_from_jax(npp), t(xs), t(ys), lr)
    assert log == ["capture"] + ["replay"] * 3
    for (w, b), (ww, wb) in zip(got_p, p):
        assert torch.equal(w, ww) and torch.equal(b, wb)
    assert torch.equal(got_c, torch.stack(want_c))
    jp, jc = jax_lg.make_sgd_scan(acts)(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in npp], jnp.asarray(xs),
        jnp.asarray(ys), lr)
    for (w, b), (jw, jb) in zip(got_p, jp):
        np.testing.assert_allclose(n(w), n(jw), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(n(b), n(jb), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(n(got_c), n(jc), rtol=1e-12, atol=1e-12)


def _old_chunk(w, x, y, lr, n_iters, n_total):
    """The chunk as the port ran it before its graph: new tensors every
    iteration, the history stacked."""
    done = torch.zeros((), dtype=torch.bool)
    history = []
    for _ in range(n_iters):
        margins = y * (x @ w)
        viol = (margins < 1.0).to(x.dtype)
        grads = -(x.T @ (viol * y))
        norms = torch.sqrt(torch.sum(grads * grads, dim=0)) / n_total
        w = torch.where(done, w, w - lr * grads)
        done = done | (torch.sum(norms) < hinge.EPSILON)
        history.append(norms)
    return w, torch.stack(history)


def _hinge_case():
    """60 examples whose run converges at its 16th iteration: inside the
    second chunk, which freezes the weights for its last four."""
    rng = np.random.default_rng(18)
    x = rng.uniform(0, 1, (60, 784)) * 2e-3
    labels = rng.integers(0, 10, 60)
    w0 = rng.normal(0, 0.01, (784, 10))
    return x, labels, w0, 2.0


def test_hinge_chunks_graphed_equal_chunk_and_jax():
    """``Chunks`` over chunks of 10, 10 and a ragged 3 (the first chunk the
    warm-up, then one replay, the tail eager): the weights and every norm
    bit-equal to the chunk loop as the port ran it, the convergence inside
    the second chunk with the freeze after it, and within 1e-12 of JAX's
    ``_train_chunk`` chunk by chunk (f64)."""
    x, labels, w0, lr = _hinge_case()
    y = hinge.signed_targets(t(labels), torch.float64)
    with torch_ranks.stood_in_graphs() as log:
        chunks = hinge.Chunks(t(w0), t(x), y, lr, 60)
        got = [chunks.run(k).clone() for k in (10, 10, 3)]
    assert log == ["capture", "replay"]
    w, jw = t(w0), jnp.asarray(w0)
    for k, hist in zip((10, 10, 3), got):
        w, want = _old_chunk(w, t(x), y, lr, k, 60)
        assert torch.equal(hist, want)
        jw, jhist = jax_hinge._train_chunk(jw, jnp.asarray(x),
                                           jnp.asarray(labels, jnp.int32),
                                           lr, k)
        np.testing.assert_allclose(n(hist), n(jhist), rtol=1e-12,
                                   atol=1e-14)
    assert torch.equal(chunks.w, w)
    np.testing.assert_allclose(n(chunks.w), n(jw), rtol=1e-12, atol=1e-14)
    sums = got[1].sum(dim=1)
    assert sums[4] >= hinge.EPSILON > sums[5]  # iteration 15 converges
    assert torch.equal(got[1][6:], got[1][6:7].expand(4, 10))


UNET_X0 = np.random.default_rng(5).uniform(-1, 1, (12, 3, 32, 32)).astype(
    np.float32)


@pytest.fixture(scope="module")
def ranks():
    """Every multi-rank case in one launch of 2 gloo CPU ranks."""
    rng = np.random.default_rng(42)
    params = {k: np.asarray(v, np.float64) for k, v in
              jax_nn.init_params(jax.random.key(5)).items()}
    x_raw = rng.integers(0, 256, (200, 784)).astype(np.float64)
    y = rng.integers(0, 10, 200).astype(np.float64)
    perm = mnist_nn.epoch_permutation(np.random.default_rng(7), 200, 64)
    hx, hl, hw, hlr = _hinge_case()
    results = torch_ranks.spawn(2, [
        ("gloo", "graphs_gloo_rule", {}),
        ("mnist", "graphs_mnist_dp_epoch", dict(
            params=params, x_raw=x_raw, y=y, perm=perm, lr=0.1, unroll=3)),
        ("hinge", "graphs_hinge_dp_chunks", dict(w=hw, x=hx, labels=hl,
                                                 lr=hlr)),
        ("unet dp", "graphs_unet_dp_epochs", dict(
            x0=UNET_X0, n_steps=5, unroll=2,
            cfg_kwargs={"param_dtype": "bfloat16"})),
        ("unet tp", "graphs_unet_tp_chunks", dict(x0=UNET_X0, n_steps=5,
                                                  unroll=2)),
    ])
    return {"ranks": results, "mnist": (params, x_raw, y, perm)}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, z in zip(a, b):
            _equal_trees(x, z)
    else:
        np.testing.assert_array_equal(a, b)


def test_gloo_rule_and_eager_reason(ranks, monkeypatch):
    """In a gloo process group a step on a card runs eagerly for gloo's
    stated reason, which rank 0 alone prints (nothing for the CPU); outside
    one, or in an NCCL one, a card's steps are graphed unless the debug
    modes or ``eager()`` hold; the CPU never."""
    for r, res in enumerate(r["gloo"] for r in ranks["ranks"]):
        assert res["reason"] == graphs.GLOO and res["cpu"] is not None
        assert res["printed"] == (f"--dp: eager steps ({graphs.GLOO})\n"
                                  if r == 0 else "")
    cuda = torch.device("cuda")
    assert graphs.eager_reason(cuda) is None
    assert graphs.eager_reason(torch.device("cpu")) is not None
    with debug.no_jit():
        assert graphs.eager_reason(cuda) is not None
    with graphs.eager():
        assert not graphs.graphs_allowed(cuda)
    assert graphs.graphs_allowed(cuda)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    for backend, allowed in (("nccl", True), ("gloo", False)):
        monkeypatch.setattr(torch.distributed, "get_backend",
                            lambda group=None, b=backend: b)
        assert graphs.graphs_allowed(cuda) is allowed


def test_mnist_dp_epoch_graphed_equals_eager_and_jax(ranks):
    """The resident DP epoch at 2 ranks on a ragged 200-example set at
    batch 64, graphs of 3 steps, run twice on one object: each epoch's
    parameters and summed metrics bit-equal to the eager DP epoch's, the
    replicas alike, and the first epoch within 1e-10 of JAX's
    ``make_epoch_resident_dp`` (f64)."""
    results = [r["mnist"] for r in ranks["ranks"]]
    for res in results:
        assert res["log"] == ["capture", "replay", "replay"]
        for (gp, gc, gce, _), (ep, ec, ece, _) in zip(res["graphed"],
                                                      res["eager"]):
            _equal_trees(gp, ep)
            assert (gc, gce) == (ec, ece)
    _equal_trees(results[0]["graphed"], results[1]["graphed"])
    params, x_raw, y, perm = ranks["mnist"]
    mesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    want, c, ce = jax_nn.make_epoch_resident_dp(
        mesh, jax_nn.Config(learn_rate=0.1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x_raw),
        jnp.asarray(y), jnp.asarray(perm))
    got, gc, gce, _ = results[0]["graphed"][0]
    for k in want:
        np.testing.assert_allclose(got[k], n(want[k]), rtol=0, atol=1e-10,
                                   err_msg=k)
    assert gc == float(c)
    np.testing.assert_allclose(gce, float(ce), rtol=1e-10)


def test_hinge_dp_chunks_graphed_equal_eager(ranks):
    """mnist_hinge ``--dp`` at 2 ranks: ``Chunks`` with its all-reduce an
    iteration in the stood-in graph, bit-equal to ``make_train_chunk_dp``'s
    chunks of 10, 10 and 3 on every rank, the ranks alike."""
    results = [r["hinge"] for r in ranks["ranks"]]
    for res in results:
        assert res["log"] == ["capture", "replay"]
        _equal_trees(res["graphed"][:2], res["eager"][:2])
    _equal_trees(results[0]["graphed"][:2], results[1]["graphed"][:2])


def test_unet_dp_epochs_graphed_equal_eager_steps(ranks):
    """Two TINY ``--bf16-params`` DP epochs of 5 steps through
    ``TrainSteps`` with the mesh (graphs of 2; ``new_epoch`` between)
    against the eager DP step on the same two generators: parameters,
    moments, step, losses and both generators' states bit-equal after each
    epoch; the bf16 replicas bit-equal across the ranks, whose own
    generators differ."""
    results = [r["unet dp"] for r in ranks["ranks"]]
    for res in results:
        assert res["log"] == ["capture"] + ["replay"] * 4
        _equal_trees(res["graphed"], res["eager"])
        assert res["graphed"][1]["step"] == 10
    a, b = (res["graphed"][1] for res in results)
    _equal_trees((a["params"], a["m"], a["v"], a["losses"], a["gens"][0]),
                 (b["params"], b["m"], b["v"], b["losses"], b["gens"][0]))
    assert not np.array_equal(a["gens"][1], b["gens"][1])


def test_unet_tp_chunks_graphed_equal_eager_steps(ranks):
    """Five TINY TP steps over a model axis of 2 through ``TrainSteps``
    with the layout (chunks of 2, a ragged tail of 1) against the eager TP
    step: the gathered parameters, moments, losses and the generator's
    state bit-equal, on both ranks alike."""
    results = [r["unet tp"] for r in ranks["ranks"]]
    for res in results:
        assert res["log"] == ["capture", "replay"]
        _equal_trees(res["graphed"], res["eager"])
    _equal_trees(results[0]["graphed"], results[1]["graphed"])


@pytest.mark.parametrize("case", ["mnist", "hinge", "unet dp", "unet tp"])
def test_collective_counters_equal_graphed_and_eager(ranks, case):
    """The collective counters (calls, bytes by kind) advance as far over
    the stood-in graph's warm-up and replays as over the eager steps, and
    every case made collectives."""
    for r in ranks["ranks"]:
        res = r[case]
        if case == "mnist":
            got = [g[3] for g in res["graphed"]]
            want = [e[3] for e in res["eager"]]
        elif case == "hinge":
            got, want = res["graphed"][2], res["eager"][2]
        else:
            got, want = res["counts"][1], res["counts"][0]
        assert got == want
        calls = want[0] if case == "hinge" or case.startswith("unet") \
            else want[0][0]
        assert calls > 0


def test_old_dp_train_state_is_refused():
    """A ``--dp`` train state of the earlier chain (a host generator, a new
    generator every step: chain "dp") is refused with its reason; a state
    of the device chain resumes the replicated stream, and the rank's
    generator, seeded from it at the next epoch, draws as the unbroken
    run's."""
    cfg = cu.TINY
    cpu = torch.device("cpu")
    p = cu.init_params(torch.Generator().manual_seed(0), cfg)
    old = cu._train_state(p, adam_init(p), torch.Generator().manual_seed(1),
                          1, cfg, cpu, "dp")
    with pytest.raises(ValueError, match="earlier version of the port"):
        cu._resume(old, cu.DPGenerators(1, 0, cpu), cfg, cpu, "dp-device")
    with pytest.raises(ValueError, match="earlier version of the port"):
        cu._resume(old, torch.Generator(), cfg, cpu, "device")
    run = cu.DPGenerators(3, 1, cpu)
    run.new_epoch()
    torch.rand(5, generator=run.rank)
    state = cu._train_state(p, adam_init(p), run, 1, cfg, cpu, "dp-device")
    resumed = cu.DPGenerators(3, 1, cpu)
    cu._resume(state, resumed, cfg, cpu, "dp-device")
    with pytest.raises(ValueError, match="a --dp run, whose draws come from "
                                         "two generators"):
        cu._resume(state, torch.Generator(), cfg, cpu, "device")
    for g in (run, resumed):
        g.new_epoch()
    assert torch.equal(torch.rand(5, generator=run.rank),
                       torch.rand(5, generator=resumed.rank))
    other = cu.DPGenerators(3, 0, cpu)
    cu._resume(state, other, cfg, cpu, "dp-device")
    other.new_epoch()
    assert not torch.equal(torch.rand(5, generator=other.rank),
                           torch.rand(5, generator=run.rank))


def test_dp_generators_draws_split_as_described():
    """``DPGenerators``: the replicated stream alike on every rank, the
    rank's stream its seed with the rank folded in (other ranks draw
    otherwise); ``new_epoch`` reads one draw of the replicated stream."""
    a, b = (cu.DPGenerators(9, r, "cpu") for r in (0, 1))
    assert torch.equal(a.get_state(), b.get_state())
    assert not torch.equal(torch.rand(3, generator=a.rank),
                           torch.rand(3, generator=b.rank))
    before = torch.Generator().set_state(a.get_state())
    a.new_epoch()
    cu._step_seed(before)
    assert torch.equal(before.get_state(), a.get_state())
