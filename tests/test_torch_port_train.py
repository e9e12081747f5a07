"""The port's training path against the JAX package: the ``Trainer`` and its
functional surface (``init_params`` / ``forward`` / ``loss_fn`` /
``make_train_step``) from the JAX package's own parameters
(:func:`params_from_jax`), ``ImageNetTrainPipeline`` with explicit boxes and
flips, and ``AAResize``.

Tolerances: the loss and the parameters after two SGD steps to 1e-5
relative (float32 convolutions and reductions in another order); the train
pipeline to one uint8 grey level through the normalisation, ``1 / (255 *
std)``, the same as the eval pipeline's test (in practice equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import interpolate_antialiasing_tpu as ia
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu.models import train as jtrain
from interpolate_antialiasing_tpu_torch.models import train as ttrain
from interpolate_antialiasing_tpu_torch.ops import crop as tcrop


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test, so that several test
    workers on one host do not contend (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=1234):
    """tests/test_models.py::test_train_step_single's batch."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((8, 3, 40, 56)).astype(np.float32)
    labels = rng.integers(0, 10, size=8)
    return imgs, labels


def _jax_params():
    return {k: np.asarray(v) for k, v in jtrain.init_params(jax.random.PRNGKey(0)).items()}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(np.abs(want).max(), 1e-30), (what, err)


def test_trainer_matches_jax_after_two_steps():
    imgs, labels = _batch()
    jp = _jax_params()
    step = jtrain.make_train_step(None, resize_to=(16, 16))
    params = {k: jnp.asarray(v) for k, v in jp.items()}
    mom = jax.tree.map(jnp.zeros_like, params)
    jlosses = []
    for _ in range(2):
        params, mom, loss = step(params, mom, jnp.asarray(imgs), jnp.asarray(labels))
        jlosses.append(float(loss))

    tr = iat.Trainer(resize_to=(16, 16), state_dict=iat.params_from_jax(jp), device="cpu")
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    losses = [float(tr.step(x, y)) for _ in range(2)]
    for a, b in zip(losses, jlosses):
        assert abs(a - b) <= 1e-5 * abs(b), (losses, jlosses)
    for k in jp:
        _close(tr.params[k].detach(), params[k], k)
        _close(tr.momentum[k], mom[k], f"momentum {k}")


def test_functional_surface_matches_jax():
    imgs, labels = _batch(seed=5)
    jp = _jax_params()
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    x = torch.from_numpy(imgs)
    _close(ttrain.forward(tp, x, (16, 16)).detach(),
           jtrain.forward(jp, jnp.asarray(imgs), (16, 16)), "logits")
    _close(ttrain.loss_fn(tp, x, torch.from_numpy(labels), (16, 16)).detach(),
           jtrain.loss_fn(jp, jnp.asarray(imgs), jnp.asarray(labels), (16, 16)), "loss")
    # the functional step over dicts is the Trainer's step
    mom = {k: torch.zeros_like(v) for k, v in tp.items()}
    step = ttrain.make_train_step(resize_to=(16, 16))
    loss = step(tp, mom, x, torch.from_numpy(labels))
    tr = iat.Trainer(resize_to=(16, 16), state_dict=iat.params_from_jax(jp), device="cpu")
    assert float(tr.step(x, torch.from_numpy(labels))) == float(loss)
    for k in tp:
        assert torch.equal(tr.params[k].detach(), tp[k])


def test_trainer_learns_on_a_fixed_batch():
    """tests/test_models.py::test_train_step_single: the loss falls over six
    steps from the port's own random init."""
    imgs, labels = _batch()
    tr = iat.Trainer(resize_to=(16, 16), device="cpu")
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    l0 = float(tr.step(x, y))
    for _ in range(5):
        loss = float(tr.step(x, y))
    assert loss < l0


def test_momentum_step_is_the_jax_update():
    """m = 0.9 m + g, p = p - lr m, op for op."""
    p = {"a": torch.tensor([1.0, -2.0])}
    m = {"a": torch.tensor([0.5, 0.25])}
    ttrain._sgd_momentum(p, m, {"a": torch.tensor([0.1, 0.2])}, 1e-2)
    m_want = np.float32(0.9) * np.array([0.5, 0.25], np.float32) + np.array([0.1, 0.2],
                                                                             np.float32)
    np.testing.assert_array_equal(m["a"].numpy(), m_want)
    np.testing.assert_array_equal(p["a"].numpy(),
                                  np.array([1.0, -2.0], np.float32)
                                  - np.float32(1e-2) * m_want)


def test_images_that_require_grad_get_their_gradient():
    """The model's resize is differentiable in its input: the image
    gradient equals jax.grad's."""
    imgs, labels = _batch(seed=9)
    jp = _jax_params()
    want = jax.grad(lambda t: jtrain.loss_fn(jp, t, jnp.asarray(labels), (16, 16)))(
        jnp.asarray(imgs))
    model = ttrain.ResizeConvNet(resize_to=(16, 16))
    model.load_state_dict(iat.params_from_jax(jp))
    x = torch.from_numpy(imgs).requires_grad_()
    logp = torch.log_softmax(model(x), dim=-1)
    loss = -logp.gather(1, torch.from_numpy(labels)[:, None]).mean()
    g, = torch.autograd.grad(loss, x)
    _close(g, want, "image gradient")


def test_params_from_jax_and_module_layout():
    jp = _jax_params()
    sd = iat.params_from_jax(jp)
    assert set(sd) == {"conv1.weight", "conv2.weight", "head", "bias"}
    model = ttrain.ResizeConvNet()
    model.load_state_dict(sd)  # strict: every key and shape matches
    assert model.conv1.weight.shape == (16, 3, 3, 3)  # OIHW, as JAX's
    assert model.head.shape == (32, 10)
    for k, v in jp.items():
        assert np.array_equal(model.params()[k].detach().numpy(), v)
    # the port's own init has the JAX package's shapes and scale
    p = ttrain.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    assert 0.05 < float(p["conv2"].std()) < 0.2 and not p["bias"].any()


def test_trainer_without_a_device_runs_on_the_card():
    """``device=None`` means the CUDA card: with none, the Trainer raises
    rather than train on the CPU; on a machine with a card, the model lands
    there."""
    if torch.cuda.is_available():
        tr = iat.Trainer(resize_to=(8, 8))
        assert all(p.is_cuda for p in tr.params.values())
        return
    with pytest.raises(RuntimeError, match="CUDA card"):
        iat.Trainer(resize_to=(8, 8))


# ---------------------------------------------------------------------------
# ImageNetTrainPipeline and AAResize
# ---------------------------------------------------------------------------


def test_train_pipeline_with_explicit_boxes_and_flips_matches_jax():
    """Explicit boxes and flips through the port's pipeline against the JAX
    pipeline's own steps (crop_and_resize with flip, which takes the dense
    route, then /255, -mean, /std)."""
    x = np.random.default_rng(2).integers(0, 256, (4, 3, 60, 90), dtype=np.uint8)
    boxes = np.array([[0.1, 0.05, 0.9, 0.8], [0.0, 0.0, 1.0, 1.0],
                      [0.3, 0.2, 0.7, 0.6], [0.05, 0.4, 0.5, 1.0]], np.float32)
    flip = np.array([True, False, False, True])
    pipe = iat.ImageNetTrainPipeline(size=(32, 40))
    got = pipe.apply(torch.from_numpy(x), torch.from_numpy(boxes), torch.from_numpy(flip))
    y = ia.crop_and_resize(jnp.asarray(x), jnp.asarray(boxes), (32, 40),
                           flip=jnp.asarray(flip))
    y = y.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    mean = jnp.asarray((0.485, 0.456, 0.406), jnp.float32).reshape(1, -1, 1, 1)
    std = jnp.asarray((0.229, 0.224, 0.225), jnp.float32).reshape(1, -1, 1, 1)
    want = np.asarray((y - mean) / std)
    assert got.dtype == torch.float32 and got.shape == (4, 3, 32, 40)
    assert np.abs(got.numpy() - want).max() <= 1.0 / (255.0 * 0.224) + 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_train_pipeline_forward_draws_boxes_and_flips():
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (6, 3, 80, 100),
                                                           dtype=np.uint8))
    pipe = iat.ImageNetTrainPipeline(size=(24, 24), dtype=torch.bfloat16)
    y = pipe(torch.Generator().manual_seed(7), x)
    assert y.dtype == torch.bfloat16 and y.shape == (6, 3, 24, 24)
    boxes, flip = pipe.sample(torch.Generator().manual_seed(7), x)
    assert boxes.shape == (6, 4) and flip.dtype == torch.bool
    assert torch.equal(y, pipe.apply(x, boxes, flip))
    # normalisation: a uniform grey image gives (v / 255 - mean) / std
    grey = torch.full((2, 3, 50, 50), 128, dtype=torch.uint8)
    g = iat.ImageNetTrainPipeline(size=(8, 8))(torch.Generator().manual_seed(0), grey)
    want = (np.float32(128) * np.float32(1 / 255) - np.array([0.485, 0.456, 0.406],
                                                             np.float32)) \
        / np.array([0.229, 0.224, 0.225], np.float32)
    np.testing.assert_allclose(g.numpy(), np.broadcast_to(want[None, :, None, None],
                                                          g.shape), atol=1e-6)
    # flip draws follow flip_prob
    _, f = iat.ImageNetTrainPipeline(flip_prob=0.0).sample(None, x)
    assert not f.any()
    assert len(list(pipe.parameters())) == 0


def test_train_pipeline_takes_the_dense_route(monkeypatch):
    from interpolate_antialiasing_tpu_torch.ops import crop_cuda

    monkeypatch.setattr(crop_cuda, "crop_and_resize_windowed",
                        lambda *a, **k: pytest.fail("windowed route taken"))
    x = torch.zeros((2, 3, 40, 40), dtype=torch.uint8)
    iat.ImageNetTrainPipeline(size=(16, 16))(torch.Generator().manual_seed(0), x)
    # the same boxes without flip would take the windowed route
    assert crop_cuda.crop_windowed_supported(x, (16, 16), "bilinear", True,
                                             tcrop.box_fracs(40, 40))


@pytest.mark.parametrize("fmt,shape", [("NCHW", (2, 3, 30, 40)), ("NHWC", (2, 30, 40, 3))])
def test_aa_resize_module_equals_resize_plane(fmt, shape):
    x = torch.from_numpy(np.random.default_rng(4).random(shape).astype(np.float32))
    m = iat.AAResize((13, 17), method="bicubic", data_format=fmt)
    h, w = (2, 3) if fmt == "NCHW" else (1, 2)
    assert torch.equal(m(x), iat.resize_plane(x, (13, 17), h, w, mode="bicubic"))
    assert len(list(m.parameters())) == 0
    xr = x.clone().requires_grad_()
    g, = torch.autograd.grad(m(xr).sum(), xr)
    g2, = torch.autograd.grad(iat.resize_plane(xr, (13, 17), h, w, mode="bicubic").sum(), xr)
    assert torch.equal(g, g2)
