"""Why mnist_nn's DP epoch can end farther from the f64 epoch than the
single-device epoch: the DP step's arithmetic (the gradients of the batch's
shards, summed in shard order) for 1, 2 and 4 shards of batch 64, each
free-running over one epoch beside the same epoch in f64 on the CPU.

    python3 tools/mnist_dp_check.py                 # on the card
    python3 tools/mnist_dp_check.py --device=cpu    # no card: the plain path

From ``mnist_nn init``'s CSVs on the 8192-image synthesized set and the
CLI's permutation (as phase 24 of ``chip_smoke.py`` prepares them) it
prints, for each shard count:

- every step's shard gradients against f64 at the same parameters with the
  card's ReLU decisions (``chip_smoke._mlp_grads_f64``), the worst
  max|err| / max|ref| per leaf (the readings behind
  ``chip_smoke.DP_GRAD_RTOL_OF_MAX``);
- the ReLU decisions that differ from the free f64 epoch's, with the f64
  pre-activation there;
- the trained leaves against the free f64 epoch and against the f64 epoch
  given the card's ReLU decisions, max|err| / max|update| per leaf.

Two ranks' all-reduce sums two f32 values, so the two-shard trajectory is
that of ``train 1 --dp`` on two ranks; four ranks may sum in another order.
"""

import contextlib
import io
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SHARDS = (1, 2, 4)


def _batch(x_all, y_all, idx, device, dtype):
    """(x scaled by a divisor on the device, onehot, mask) of rows idx."""
    x = x_all[idx].to(device, dtype) / chip_smoke.torch.full(
        (), 255.0, dtype=dtype, device=device)
    onehot = chip_smoke.torch.nn.functional.one_hot(
        y_all[idx].long(), 10).to(device, dtype)
    return x, onehot, chip_smoke.torch.ones(len(idx), device=device,
                                            dtype=dtype)


def _grads(model, x, onehot, mask, cfg):
    """(the loss gradient of ``model`` per leaf, the ReLU decisions)."""
    from big_linear_algebra_tpu_torch.models import mnist_nn

    def run():
        model.zero_grad(set_to_none=True)
        with chip_smoke.torch.enable_grad():
            mnist_nn.loss_and_metrics(model, x, onehot, mask,
                                      cfg)[0].backward()
        return {k: p.grad.detach().clone()
                for k, p in model.params().items()}

    return chip_smoke._with_decisions(model, run)


def main(argv) -> int:
    import numpy as np
    import torch

    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist_nn

    device = "cpu" if "--device=cpu" in argv else "cuda"
    smi = ""
    if device == "cuda":
        smi, _ = chip_smoke.phase_environment()
    cfg = mnist_nn.CONFIG
    with tempfile.TemporaryDirectory(prefix="bla_check_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        with contextlib.redirect_stdout(io.StringIO()):
            synth.ensure_mnist(tmp)
            mnist_nn.main(["init"])
        initial = mnist_nn.load_params_csv()
        data = MnistDataset.from_csv(os.path.join(tmp, "mnist",
                                                  "mnist_train.csv"))
        del os.environ["BLA_DATA_DIR"]
    perm = torch.from_numpy(mnist_nn.epoch_permutation(
        np.random.default_rng(cfg.seed), data.num_examples,
        cfg.batch_size)).long()
    x_all, y_all = torch.from_numpy(data.x), torch.from_numpy(data.y)
    batch = cfg.batch_size
    steps = perm.numel() // batch

    ref = mnist_nn.MnistNN.from_params(initial, dtype=torch.float64)
    cards = {n: mnist_nn.MnistNN.from_params(initial, device=device)
             for n in SHARDS}
    given = {n: {k: v.double() for k, v in initial.items()} for n in SHARDS}
    worst = {n: {} for n in SHARDS}
    flips = {n: [] for n in SHARDS}
    for s in range(steps):
        rows = perm[s * batch:(s + 1) * batch]
        x64, onehot64, mask64 = _batch(x_all, y_all, rows, "cpu",
                                       torch.float64)
        g64, d64 = _grads(ref, x64, onehot64, mask64, cfg)
        for n in SHARDS:
            card = cards[n]
            params = {k: v.detach().clone() for k, v in card.params().items()}
            total, decided = {}, [[], []]
            for shard in rows.reshape(n, batch // n):
                x, onehot, mask = _batch(x_all, y_all, shard, device,
                                         torch.float32)
                g, d = _grads(card, x, onehot, mask, cfg)
                want = chip_smoke._mlp_grads_f64(params, x, onehot, mask, d,
                                                 cfg)
                for k in g:
                    r = chip_smoke._of_max(g[k], want[k])
                    if r > worst[n].get(k, (-1.0, 0))[0]:
                        worst[n][k] = (r, s)
                    total[k] = total[k] + g[k] if k in total else g[k]
                for layer in (0, 1):
                    decided[layer].append(d[layer].cpu())
            decided = [torch.cat(d) for d in decided]
            for layer in (0, 1):
                for e, u in (decided[layer] != d64[layer]).nonzero().tolist():
                    p = {k: v.detach() for k, v in ref.params().items()}
                    a = x64[e]
                    for i in range(1, layer + 2):
                        z = a @ p[f"w{i}"] + p[f"b{i}"]
                        a = torch.clamp_min(z, 0.0)
                    flips[n].append((s, layer + 1, e, u, z[u].item()))
            step_given = chip_smoke._mlp_grads_f64(
                given[n], x64, onehot64, mask64, decided, cfg)
            with torch.no_grad():
                for k, p in card.params().items():
                    p -= cfg.learn_rate * total[k]
                for k in given[n]:
                    given[n][k] -= cfg.learn_rate * step_given[k]
        with torch.no_grad():
            for k, p in ref.params().items():
                p -= cfg.learn_rate * g64[k]

    free = {k: v.detach() for k, v in ref.params().items()}
    where = f" | {smi}" if smi else ""
    for n in SHARDS:
        got = {k: v.detach().cpu() for k, v in cards[n].params().items()}
        vs_free = chip_smoke._of_update(got, free, initial)
        vs_given = chip_smoke._of_update(got, given[n], initial)
        print(f"[dp shards] {n} shard(s) of {batch // n} on {device}, "
              f"{steps} steps: each shard's gradient against f64 at the "
              f"same parameters with the card's ReLU decisions, worst "
              f"max|err| / max|ref| per leaf (step) "
              + ", ".join(f"{k} {v:.3e} ({s})" for k, (v, s) in
                          worst[n].items())
              + f"; ReLU decisions other than the free f64 epoch's: "
              f"{len(flips[n])} (step, layer, example, unit, f64 "
              f"pre-activation) "
              + ", ".join(f"({s}, {l}, {e}, {u}, {z:.3e})"
                          for s, l, e, u, z in flips[n][:8])
              + "; trained leaves against the free f64 epoch, max|err| / "
              f"max|update| "
              + ", ".join(f"{k} {v:.3e}" for k, v in vs_free.items())
              + ", against the f64 epoch given the card's ReLU decisions "
              + ", ".join(f"{k} {v:.3e}" for k, v in vs_given.items())
              + where, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
