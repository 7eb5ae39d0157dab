"""The ADM U-Net on the card (marked ``card``; each skips without CUDA):

- at the TINY widths in bf16, the shared ``TrainSteps`` graphed (a warm-up
  step, the capture of two, replays) bit-equal to the same steps run
  eagerly: parameters, moments, loss terms and the generator's state;
- at the published widths, one eager step at batch 2: 7 flash and 15 dense
  attention calls by the route counter, and under the profiler the marks
  ``bla_mark_attention`` and ``bla_mark_attention_end`` once per block in
  the forward and once per block in the backward, each start before its
  end.

This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_adm_card.py -m card --noconftest
"""

import dataclasses
import json

import pytest
import torch

from big_linear_algebra_tpu_torch.models import adm_unet as adm
from big_linear_algebra_tpu_torch.nn import attention
from big_linear_algebra_tpu_torch.nn.optim import adam_init, tree_leaves
from big_linear_algebra_tpu_torch.utils import graphs
from tests.torch_parity import card


def _state(steps):
    return [t.clone() for tree in (steps.params, steps.m, steps.v)
            for t in tree_leaves(tree)]


def _run(cfg, device, graphed: bool):
    g = torch.Generator(device=device).manual_seed(11)
    params = adm.init_params(g, cfg)
    for leaf in tree_leaves(params):  # no zero-initialised leaves
        leaf.add_(0.05 * torch.rand(leaf.shape, generator=g, device=device))
    data = torch.empty((32, 3, cfg.image_size, cfg.image_size),
                       device=device).uniform_(-1, 1, generator=g)
    labels = torch.randint(0, cfg.num_classes, (32,), generator=g,
                           device=device)
    gen = torch.Generator(device=device).manual_seed(12)
    rows = torch.randperm(32, generator=g, device=device)[:5 * 4].view(5, 4)
    steps = adm.train_steps(params, adam_init(params), data, labels, gen,
                            cfg)
    assert steps.graph.graphed == graphed
    terms = steps.run(rows)
    return terms, _state(steps), gen.get_state(), steps.graph.replays


@pytest.mark.card
def test_graphed_steps_are_the_eager_steps():
    device = card()
    cfg = dataclasses.replace(adm.TINY, compute_dtype="bfloat16",
                              batch_size=4)
    terms, state, rng, replays = _run(cfg, device, True)
    with graphs.eager():
        e_terms, e_state, e_rng, _ = _run(cfg, device, False)
    assert replays == 2 and terms.shape == (5, 2)
    assert torch.equal(terms, e_terms) and torch.equal(rng, e_rng)
    assert all(torch.equal(a, b) for a, b in zip(state, e_state))


@pytest.mark.card
def test_published_step_routes_and_marks(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    device = card()
    cfg = dataclasses.replace(adm.CONFIG, batch_size=2)
    g = torch.Generator(device=device).manual_seed(13)
    params = adm.init_params(g, cfg)
    x0 = torch.empty((2, 3, 64, 64), device=device).uniform_(-1, 1,
                                                              generator=g)
    y = torch.tensor([3, 999], device=device)
    adm.step_grads(params, x0, y, g, cfg)  # builds and loads the kernels
    torch.cuda.synchronize()
    before = dict(attention.route_calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        adm.step_grads(params, x0, y, g, cfg)
        torch.cuda.synchronize()
    assert {k: attention.route_calls[k] - v for k, v in before.items()} == {
        "flash": 7, "dense": 15}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    marks = sorted((e["ts"], e["name"]) for e in json.loads(
        path.read_text())["traceEvents"]
        if e.get("cat") == "kernel"
        and e.get("name", "").startswith("bla_mark_attention"))
    names = [n for _, n in marks]
    assert names.count("bla_mark_attention") == 2 * 22
    assert names.count("bla_mark_attention_end") == 2 * 22
    assert names == ["bla_mark_attention", "bla_mark_attention_end"] * 44
