"""The port's ``utils/debug.py`` (``checked``, ``debug_nans``, ``no_jit``,
``validate_finite``) against the JAX package's ``utils`` and the
``--debug-nans`` / ``--disable-jit`` CLI flags, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.data import synth as jax_synth
from big_linear_algebra_tpu.utils import validate_finite as jax_validate_finite
from big_linear_algebra_tpu_torch.models import mnist_nn
from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.ops.matmul import matmul
from big_linear_algebra_tpu_torch.utils import (
    checked,
    debug_nans,
    no_jit,
    validate_finite,
)
from tests.torch_parity import n, t


def test_checked_catches_nan():
    """``checked`` returns the function's result on valid input and raises
    ``FloatingPointError`` naming the op that made the NaN."""
    safe = checked(torch.log)
    assert float(safe(torch.tensor(2.0))) == pytest.approx(np.log(2.0))
    with pytest.raises(FloatingPointError, match=r"aten\.log\.default"):
        safe(torch.tensor(-1.0))


def test_validate_finite_message_matches_jax():
    """The same nested tree in both packages: the same first leaf, named by
    the same path (``jax.tree_util.keystr``'s spelling)."""
    bad = np.array([1.0, np.nan])
    tree = {"b": [np.ones(2), (np.ones(1), bad)], "a": {"x": np.ones(3)},
            "c": bad}
    messages = []
    for validate, leaf in ((jax_validate_finite, jnp.asarray),
                           (validate_finite, t)):
        as_tree = {"b": [leaf(tree["b"][0]),
                         (leaf(tree["b"][1][0]), leaf(tree["b"][1][1]))],
                   "a": {"x": leaf(tree["a"]["x"])}, "c": leaf(bad)}
        validate({"a": as_tree["a"], "b": as_tree["b"][0]})
        with pytest.raises(FloatingPointError) as err:
            validate({"params": as_tree, "step": 3}, "state")
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert messages[1] == ("state['params']['b'][1][1] contains non-finite "
                           "values")
    validate_finite([torch.ones(2, dtype=torch.bfloat16), 1.0, None])
    with pytest.raises(FloatingPointError, match=r"^x\[0\] contains"):
        validate_finite([torch.tensor([float("inf")])], "x")


def test_no_jit_context(rng):
    a, b = rng.standard_normal((4, 5)), rng.standard_normal((5, 6))
    with no_jit():
        out = matmul(t(a), t(b))
    np.testing.assert_allclose(n(out), a @ b, rtol=1e-12)


def test_debug_nans_reads_only_what_ops_computed():
    """Uninitialized memory and views are not checked; computed outputs,
    in-place and ``out=`` results included, are; the check does not
    change a clean result."""
    nan = torch.full((4,), float("nan"))
    with debug_nans():
        torch.empty(1 << 16)
        torch.empty_like(nan)
        torch.empty_strided((2, 2), (1, 2))
        nan.new_empty((3,))
        nan.view(2, 2).t()[0]            # views compute nothing
        clean = torch.arange(4.0) * 2
        with pytest.raises(FloatingPointError, match=r"aten\.add_\.Tensor"):
            torch.zeros(4).add_(nan)
        with pytest.raises(FloatingPointError, match=r"aten\.mul\.out"):
            torch.mul(nan, 2, out=torch.zeros(4))
    assert torch.equal(clean, torch.arange(4.0) * 2)
    with debug_nans(enable=False):
        torch.log(torch.tensor(-1.0))


def test_debug_nans_sees_the_hand_written_backwards(rng):
    """A NaN that first appears in autograd's backward, through K1's
    hand-written ``_MatmulFn`` backward, raises there: the forward passes
    and the backward's first op with a NaN output is named."""
    a = t(rng.standard_normal((3, 4))).requires_grad_()
    b = t(rng.standard_normal((4, 2)))
    g = torch.full((3, 2), float("nan"), dtype=torch.float64)
    with debug_nans():
        out = matmul(a, b)
        with pytest.raises(FloatingPointError, match=r"aten\.mm\.default"):
            out.backward(g)


def test_kernel_launch_outputs_are_checked():
    """``cuda_utils.check`` hands a launch's outputs to the modes: under
    ``debug_nans`` a NaN in them raises naming the launch; outside, nothing
    is checked. (A return code of 0 never touches the library.)"""
    nan = torch.tensor([0.0, float("nan")])
    cuda_utils.check(None, 0, "K0 kernel launch", nan, None)
    with no_jit():
        cuda_utils.check(None, 0, "K0 kernel launch", nan)
    with debug_nans(), pytest.raises(FloatingPointError,
                                     match="K0 kernel launch"):
        cuda_utils.check(None, 0, "K0 kernel launch", None, nan)


def test_train_step_raises_on_a_nan_pixel():
    """One ``train_step`` under ``debug_nans`` with one NaN pixel raises at
    the first layer's product (on the card: K1's launch)."""
    model = mnist_nn.MnistNN.from_params(
        mnist_nn.init_params(torch.Generator().manual_seed(0)))
    x = torch.rand(64, 784, generator=torch.Generator().manual_seed(1))
    x[3, 400] = float("nan")
    onehot = torch.nn.functional.one_hot(torch.arange(64) % 10, 10).float()
    mnist_nn.train_step(model, x.nan_to_num(), onehot, torch.ones(64))
    with debug_nans(), pytest.raises(FloatingPointError,
                                     match=r"aten\.mm\.default"):
        mnist_nn.train_step(model, x, onehot, torch.ones(64))


def test_mnist_nn_train_under_the_flags_is_bit_equal(tmp_path, monkeypatch):
    """``mnist_nn train 1 --debug-nans --disable-jit --device=cpu`` on a
    small set trains the same parameters, bit for bit (before the CSV's six
    decimals), as without them; ``run`` takes the flags too."""
    saved = []
    real = mnist_nn.save_params_csv

    def save(params, base=None):
        saved.append({k: v.detach().clone() for k, v in params.items()})
        real(params, base)

    monkeypatch.setattr(mnist_nn, "save_params_csv", save)
    for i, flags in enumerate(([], ["--debug-nans", "--disable-jit"])):
        where = tmp_path / str(i)
        monkeypatch.setenv("BLA_DATA_DIR", str(where))
        jax_synth.ensure_mnist(str(where), train_n=256, test_n=16)
        assert mnist_nn.main(["init"]) == 0
        assert mnist_nn.main(["train", "1", "--device=cpu", *flags]) == 0
        assert mnist_nn.main(["run", "--device=cpu", *flags]) == 0
    plain, flagged = saved[1], saved[3]  # each directory's train
    assert plain.keys() == flagged.keys()
    for k in plain:
        assert torch.equal(plain[k].view(torch.int32),
                           flagged[k].view(torch.int32)), k
    assert not torch.equal(plain["w1"], saved[0]["w1"])  # it trained
    with pytest.raises(ValueError, match="takes no value"):
        mnist_nn.main(["run", "--device=cpu", "--debug-nans=1"])
