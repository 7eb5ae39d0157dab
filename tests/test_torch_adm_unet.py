"""The ADM U-Net (``models/adm_unet.py``) against the benchmark's plain
reference (``portbench/reference_adm.py``: plain torch, float32, written
from guided-diffusion's code), on the CPU at the TINY widths: two levels at
32×32, attention at 32×32 (1024 tokens, the flash route) and 16×16.

- the forward, both loss terms and every leaf's gradient of one train step
  on the reference's seeded weights (f32: the two compute the same sums in
  other orders, through GroupNorm'd blocks; the worst leaf stands ~1e-5
  from the reference, so 1e-4 of each leaf's norm);
- the hybrid terms at t = 0 (the decoder's NLL) and t > 0 (the KL), and
  the cosine schedule's table, against the reference's arrays (any other
  schedule is refused);
- the route counter: the 1024-token sites take ``flash_attention``;
- the published configuration: 295.9M parameters, counted from shapes on
  the ``meta`` device, and its attention sites by resolution;
- the affine GroupNorm's and SiLU's backwards against autograd (f64);
- the shared ``TrainSteps`` driving ADM's step, and the ``init``/``train``
  CLI with a resume.

This file imports no JAX.
"""

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from big_linear_algebra_tpu_torch.models import adm_unet as adm
from big_linear_algebra_tpu_torch.nn import attention
from big_linear_algebra_tpu_torch.nn.norm import group_norm_affine
from big_linear_algebra_tpu_torch.nn.optim import adam_init, tree_leaves
from big_linear_algebra_tpu_torch.ops.activations import silu
from portbench import reference_adm as ref

TINY = dataclasses.asdict(adm.TINY)


def _batch(seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    params = ref.make_params(g, TINY)
    x0 = torch.empty(b, 3, 32, 32).uniform_(-1, 1, generator=g)
    y = torch.randint(0, TINY["num_classes"], (b,), generator=g)
    return params, x0, y


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_tree_is_the_references():
    for cfg in (adm.TINY, adm.CONFIG):
        mine = [(p, s) for p, s, _ in adm.param_specs(cfg)]
        theirs = [(p, s) for p, s, _ in ref.param_specs(
            dataclasses.asdict(cfg))]
        assert mine == theirs


def test_forward_matches_the_reference():
    params, x0, y = _batch()
    t = torch.tensor([3, 700])
    got = adm.forward(params, x0, t, y, adm.TINY)
    want = ref.forward(params, x0, t, y, TINY)
    assert got.shape == (2, 6, 32, 32)
    assert _rel(got, want) < 1e-5


def test_step_matches_the_reference():
    """One step's (L_simple, L_t) and every leaf's gradient, from the same
    generator (t, ε, then the dropout masks in block order)."""
    params, x0, y = _batch(1)
    terms, grads, seed, index = adm.step_grads(
        params, x0, y, torch.Generator().manual_seed(5), adm.TINY)
    assert seed is None and index is None
    want_terms, want = ref.loss_and_grads(
        params, x0, y, torch.Generator().manual_seed(5), TINY, chunk=1)
    torch.testing.assert_close(terms, want_terms, rtol=1e-5, atol=0)
    for path, g, w in zip(ref.leaf_paths(TINY), tree_leaves(grads), want):
        assert _rel(g, w) < 1e-4, path


def test_hybrid_terms_at_both_ends():
    """t = 0 takes the decoder's NLL, t > 0 the KL; the ε̂ half carries no
    gradient from L_t."""
    g = torch.Generator().manual_seed(2)
    x0 = torch.empty(4, 3, 8, 8).uniform_(-1, 1, generator=g)
    x0[0, 0, 0, :2] = torch.tensor([-1.0, 1.0])  # the open edge bins
    noise = torch.randn(x0.shape, generator=g)
    out = torch.randn(4, 6, 8, 8, generator=g) * 0.5
    t = torch.tensor([0, 1, 400, 999])
    table = adm.schedule(adm.TINY, "cpu")
    arr = ref.diffusion_arrays(TINY, "cpu")
    xt = (table[t, 0][:, None, None, None] * x0
          + table[t, 1][:, None, None, None] * noise)
    out.requires_grad_()
    got = adm.hybrid_terms(out, x0, xt, t, noise, table)
    mse, vb = ref.per_image_terms(out, x0, xt, t, noise, arr)
    torch.testing.assert_close(got, torch.stack([mse.mean(), vb.mean()]),
                               rtol=1e-6, atol=0)
    (grad,) = torch.autograd.grad(got[1], out)
    assert not grad[:, :3].any() and grad[:, 3:].any()


def test_schedule_is_the_references():
    table = adm.schedule(adm.TINY, "cpu")
    arr = ref.diffusion_arrays(dataclasses.asdict(adm.TINY), "cpu")
    names = ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
             "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
             "posterior_mean_coef1", "posterior_mean_coef2",
             "posterior_log_variance_clipped", "log_betas")
    for i, name in enumerate(names):
        assert torch.equal(table[:, i], arr[name]), name
    assert float(adm.betas(adm.TINY).max()) == 0.999


def test_only_the_cosine_schedule():
    with pytest.raises(ValueError, match="cosine"):
        dataclasses.replace(adm.TINY, noise_schedule="linear")


def test_long_sites_take_flash():
    """TINY's three 32×32 sites (1024 tokens) take ``flash_attention``, its
    four 16×16 sites the dense product, by the route counter."""
    params, x0, y = _batch()
    before = dict(attention.route_calls)
    adm.forward(params, x0, torch.tensor([1, 2]), y, adm.TINY)
    assert {k: attention.route_calls[k] - v for k, v in before.items()} == {
        "flash": 3, "dense": 4}


def test_published_configuration():
    assert adm.count_params(adm.CONFIG) == 295_904_454
    sites = [op for ops in adm.plan(adm.CONFIG) for op in ops
             if op.kind == "attn"]
    by_side = {}
    for op in sites:
        by_side.setdefault(op.size, set()).add(op.heads)
        assert op.cin == op.heads * 64
    assert {k: len([o for o in sites if o.size == k]) for k in by_side} == {
        32: 7, 16: 7, 8: 8}
    assert by_side == {32: {6}, 16: {9}, 8: {12}}
    assert len([op for ops in adm.plan(adm.CONFIG) for op in ops
                if op.kind == "res"]) == 36


def test_group_norm_affine_and_silu_backwards():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 3, 5, generator=g, dtype=torch.float64)
    gamma = 1 + 0.1 * torch.randn(8, generator=g, dtype=torch.float64)
    beta = torch.randn(8, generator=g, dtype=torch.float64)
    cot = torch.randn(x.shape, generator=g, dtype=torch.float64)
    ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    got = torch.autograd.grad((group_norm_affine(*ins, groups=4) * cot)
                              .sum(), ins)
    ins2 = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    want = torch.autograd.grad((F.group_norm(ins2[0], 4, ins2[1], ins2[2],
                                             eps=1e-5) * cot).sum(), ins2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    xs = x.clone().requires_grad_()
    xs2 = x.clone().requires_grad_()
    torch.testing.assert_close(
        torch.autograd.grad((silu(xs) * cot).sum(), xs)[0],
        torch.autograd.grad((F.silu(xs2) * cot).sum(), xs2)[0],
        rtol=1e-12, atol=1e-14)


def test_train_steps_drive_the_adm_step():
    """``cifar_unet.TrainSteps`` with ADM's ``step_fn``: the (k, 2) loss
    terms are ``step_grads``' on the same rows, labels and generator."""
    params, _, _ = _batch(3)
    g = torch.Generator().manual_seed(6)
    data = torch.empty(8, 3, 32, 32).uniform_(-1, 1, generator=g)
    labels = torch.randint(0, 10, (8,), generator=g)
    steps = adm.train_steps(params, adam_init(params), data, labels,
                            torch.Generator().manual_seed(7), adm.TINY)
    rows = torch.tensor([[0, 5], [3, 1]])
    terms = steps.run(rows)
    assert terms.shape == (2, 2) and steps.step == 2
    first = adm.step_grads(params, data[rows[0]], labels[rows[0]],
                           torch.Generator().manual_seed(7), adm.TINY)[0]
    assert torch.equal(terms[0], first)
    assert not torch.equal(steps.params["out"]["conv"]["w"],
                           params["out"]["conv"]["w"])


def test_cli_init_train_resume(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BLA_DATA_DIR", str(tmp_path))
    assert adm.main(["init", "--tiny"]) == 0
    args = ["train", "1", "--tiny", "--device=cpu", "--rows=8",
            "--max-steps=2"]
    assert adm.main(args) == 0
    assert adm.main(args) == 0
    out = capsys.readouterr().out
    assert "initialized 213382 parameters" in out
    assert "resumed at step 2, epoch 1" in out and "steps: 4" in out
    state = torch.load(tmp_path / "adm_unet" / "train_state" / "state.pt")
    assert state["step"] == 4 and all(
        math.isfinite(float(p.sum())) for p in tree_leaves(state["params"]))
    assert adm.main(["run"]) == 2
