"""The port's segmentation-head training against the reference's on the CPU:
targets, the loss and its gradients on flax parameters carried across by
``convert.seghead_from_flax``, Adam steps against optax, the cosine
schedule, the initializers' statistics, and checkpoints that either
package reads."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instancefusion_tpu.datasets import synthetic as jsyn
from instancefusion_tpu.models import segmentation as jseg
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.models import segmentation as pseg
from tests.helpers import SMALL_INTR
from tests.torch_helpers import n, t

NC, WIDTH = 9, 8


def _flax_arrays(params) -> dict:
    """Flax parameters keyed as ``save_pretrained`` keys them (fp32)."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(kp): np.asarray(leaf, np.float32) for kp, leaf in flat}


def _port_head(params) -> pseg.PanopticHead:
    model = pseg.PanopticHead(NC, WIDTH)
    model.load_state_dict(convert.seghead_from_flax(_flax_arrays(params)))
    return model


@pytest.fixture(scope="module")
def batch():
    """The reference test's frame (tests/test_instances.py): a rendered
    120x160 view resized to 60x80, its instance ids and targets, and the
    flax parameters of ``init_params(PRNGKey(0), 60, 80, 9, 8)`` (jitted:
    the same values, a quarter of the time)."""
    f = jsyn.render_frame(jsyn.orbit_trajectory(3)[1], SMALL_INTR)
    rgb = jax.image.resize(f.color, (60, 80, 3), "linear")
    inst = jax.image.resize(f.instance.astype(jnp.float32), (60, 80),
                            "nearest").astype(jnp.int32)
    cls = jnp.arange(8, dtype=jnp.int32) + 1
    targets = jseg.targets_from_instances(inst, cls)
    init = jax.jit(jseg.init_params, static_argnums=(1, 2, 3, 4))
    params = init(jax.random.PRNGKey(0), 60, 80, NC, WIDTH)
    return rgb, targets, params


def _instance_image(seed: int, h: int = 48, w: int = 64, k: int = 6) -> np.ndarray:
    """Blocky instance ids in [-1, k) from a seeded coarse grid."""
    coarse = np.random.default_rng(seed).integers(-1, k, (h // 8, w // 8))
    return np.repeat(np.repeat(coarse, 8, 0), 8, 1).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_targets_from_instances_match_reference(seed):
    """sem exactly, center and offset within 1e-6, on a seeded blocky
    instance image (one class id unused, so one instance is empty)."""
    inst = _instance_image(seed)
    cls = np.array([0, 1, 2, 3, 1, 4, 2, 3], np.int32)
    ref = jseg.targets_from_instances(jnp.asarray(inst), jnp.asarray(cls))
    got = pseg.targets_from_instances(t(inst), t(cls))
    np.testing.assert_array_equal(n(got[0]), np.asarray(ref[0]))
    np.testing.assert_allclose(n(got[1]), np.asarray(ref[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(got[2]), np.asarray(ref[2]), rtol=0, atol=1e-6)


def test_targets_from_rendered_frame_match_reference(batch):
    _, ref, _ = batch
    f = jsyn.render_frame(jsyn.orbit_trajectory(3)[1], SMALL_INTR)
    inst = jax.image.resize(f.instance.astype(jnp.float32), (60, 80),
                            "nearest").astype(jnp.int32)
    got = pseg.targets_from_instances(t(np.asarray(inst)), torch.arange(8) + 1)
    np.testing.assert_array_equal(n(got[0]), np.asarray(ref[0]))
    np.testing.assert_allclose(n(got[1]), np.asarray(ref[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(got[2]), np.asarray(ref[2]), rtol=0, atol=1e-6)


def _noise_biases(model) -> set:
    """The conv biases that the next GroupNorm removes (one channel a
    group): their gradient is 0 but for rounding noise."""
    return {f"blocks.{i}.conv.bias" for i, blk in enumerate(model.blocks)
            if blk.norm.num_groups == blk.norm.num_channels}


def test_loss_and_gradients_match_reference(batch):
    """The loss within 1e-5 relative (and each part).  Every parameter's
    gradient within 1e-4 of the tensor's largest gradient against the same
    head run in float64, and within 2e-4 against the reference's: the
    reference's own fp32 gradient is up to 1.44e-4 off the float64 one
    (the port's 3e-6), so 1e-4 would hold the port to the reference's
    rounding.  The biases that GroupNorm removes (width 8: blocks 0 and 7)
    have a zero gradient up to rounding noise: within 1e-4 of the head's
    largest gradient in all three."""
    rgb, targets, params = batch
    (loss, aux), grads = jax.value_and_grad(jseg.loss_fn, has_aux=True)(
        params, rgb, *targets, num_classes=NC, width=WIDTH)
    want = convert.seghead_from_flax(_flax_arrays(grads))
    got = {}
    for dtype in (torch.float32, torch.float64):
        model = _port_head(params).to(dtype)
        x = t(np.asarray(rgb)).to(dtype)
        sem, center, offset = (t(np.asarray(v)) for v in targets)
        total, parts = pseg.loss_fn(model, x, sem, center.to(dtype), offset.to(dtype))
        total.backward()
        got[dtype] = {name: p.grad.double() for name, p in model.named_parameters()}
        if dtype == torch.float32:
            assert abs(float(total) - float(loss)) <= 1e-5 * abs(float(loss))
            for name in ("ce", "center", "offset"):
                assert abs(float(parts[name]) - float(aux[name])) <= 1e-5 * abs(float(aux[name]))
    g32, g64 = got[torch.float32], got[torch.float64]
    assert want.keys() == g32.keys()
    noise = _noise_biases(model)
    assert noise == {"blocks.0.conv.bias", "blocks.7.conv.bias"}
    top = max(float(v.abs().max()) for v in g64.values())
    for name, g in g32.items():
        ref = want[name].double()
        if name in noise:
            for x in (g, ref, g64[name]):
                assert float(x.abs().max()) <= 1e-4 * top, name
            continue
        scale = float(g64[name].abs().max())
        assert float((g - g64[name]).abs().max()) <= 1e-4 * scale, name
        assert float((g - ref).abs().max()) <= 2e-4 * scale, name


def test_adam_steps_match_optax(batch):
    """Twelve ``train_step``s with ``torch.optim.Adam(lr=1e-2)`` against the
    reference's with ``optax.adam(1e-2)`` on the same frame, both in
    float64: every parameter within 1e-4; and in float32 the port's loss
    falls below 0.75x its first value (the reference's
    tests/test_instances.py).  float64, because Adam's step m / sqrt(v)
    takes a full step of either sign on a gradient element near zero: in
    float32 the reference's gradient rounding (1e-4 of a tensor's largest,
    see above) moves such weights up to 2e-2 apart in twelve steps.  Held
    out for the same reason: the biases that GroupNorm removes, whose
    gradient is noise at any precision."""
    rgb, targets, params = batch
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
        x64 = jnp.asarray(rgb, jnp.float64)
        y64 = (targets[0], *(jnp.asarray(v, jnp.float64) for v in targets[1:]))
        tx = optax.adam(1e-2)
        opt_state = tx.init(p64)
        step = jax.jit(lambda p, o, x, y: jseg.train_step(p, o, x, y, tx, NC, WIDTH))
        for _ in range(12):
            p64, opt_state, _, _ = step(p64, opt_state, x64, y64)
        want = convert.seghead_from_flax(_flax_arrays(p64))
    sem, center, offset = (t(np.asarray(v)) for v in targets)
    losses = {}
    for dtype in (torch.float64, torch.float32):
        model = _port_head(params).to(dtype)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        x, y = t(np.asarray(rgb)).to(dtype), (sem, center.to(dtype), offset.to(dtype))
        losses[dtype] = [float(pseg.train_step(model, opt, x, y)[0]) for _ in range(12)]
        if dtype == torch.float64:
            noise = _noise_biases(model)
            for name, p in model.named_parameters():
                if name not in noise:
                    err = float((p.detach().float() - want[name]).abs().max())
                    assert err <= 1e-4, (name, err)
    f32 = losses[torch.float32]
    assert f32[-1] < 0.75 * f32[0], f32


@pytest.mark.parametrize("steps,alpha", [(4000, 0.05), (12, 0.0)])
def test_cosine_decay_matches_optax(steps, alpha):
    sched = optax.cosine_decay_schedule(1e-3, steps, alpha=alpha)
    rate = pseg.cosine_decay(1e-3, steps, alpha)
    for s in (0, steps // 2, steps, steps + 5):
        assert abs(rate(s) - float(sched(s))) <= 1e-6 * float(sched(0)), s
    opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=1.0)
    lam = torch.optim.lr_scheduler.LambdaLR(opt, rate)
    for s in range(3):
        assert opt.param_groups[0]["lr"] == rate(s)
        opt.step()
        lam.step()


def test_init_params_statistics(batch):
    """flax's initializers: every conv kernel within +-2 of its
    sqrt(1/fan_in)/0.8796 stddev; on the layers of >= 1000 weights the
    mean within 0.1 stddev and the stddev within 10% of flax's on the same
    shapes; biases 0, GroupNorm scale 1 and bias 0, as flax's."""
    ref = convert.seghead_from_flax(_flax_arrays(batch[2]))
    gen = torch.Generator().manual_seed(0)
    model = pseg.init_params(60, 80, NC, WIDTH, gen, device="cpu")
    got = model.state_dict()
    assert got.keys() == ref.keys()
    checked = 0
    for name, w in got.items():
        r = ref[name]
        if w.dim() == 4:
            sigma = (1.0 / (w.shape[1] * w.shape[2] * w.shape[3])) ** 0.5 / 0.87962566103423978
            assert float(w.abs().max()) <= 2.0 * sigma * (1 + 1e-6), name
            assert float(r.abs().max()) <= 2.0 * sigma * (1 + 1e-6), name
            if w.numel() >= 1000:
                assert abs(float(w.mean()) - float(r.mean())) <= 0.1 * float(r.std()), name
                assert abs(float(w.std()) - float(r.std())) <= 0.1 * float(r.std()), name
                checked += 1
        else:
            assert torch.equal(w, r), name
    assert checked >= 7
    again = pseg.init_params(60, 80, NC, WIDTH, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got.values(), again.state_dict().values()))


def test_save_pretrained_round_trip(tmp_path):
    """A head the port saves loads in the reference's ``load_pretrained``
    and in the port's, equal to the head's parameters rounded to fp16."""
    meta = pseg.PRETRAINED_SYNTHETIC
    model = pseg.init_params(8, 8, meta["num_classes"], meta["width"],
                             torch.Generator().manual_seed(3), device="cpu")
    path = tmp_path / "head.npz"
    pseg.save_pretrained(path, model)
    rounded = {k: v.half().float() for k, v in model.state_dict().items()}
    params, nc, width = jseg.load_pretrained(str(path))
    assert (nc, width) == (meta["num_classes"], meta["width"])
    ref = convert.seghead_from_flax(_flax_arrays(params))
    back = pseg.load_pretrained(path, device="cpu").state_dict()
    for name, want in rounded.items():
        assert torch.equal(ref[name], want), name
        assert torch.equal(back[name], want), name


@pytest.mark.parametrize("sizes", [((30, 40), (60, 80)), ((8, 10), (15, 20))])
def test_upsample_matches_reference(sizes):
    """The head's upsampling: its forward is ``F.interpolate``'s bit for bit,
    and its backward (two matrix products, a fixed order on the card) gives
    the gradient of the reference's ``jax.image.resize`` bilinear within
    1e-5, and ``F.interpolate``'s own within 1e-6 of its largest element
    (1e-12 in float64)."""
    (ih, iw), (oh, ow) = sizes
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, ih, iw)).astype(np.float32)
    g = rng.standard_normal((2, 3, oh, ow)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax.image.resize(v, (2, 3, oh, ow), "bilinear"), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        y = pseg._Upsample.apply(xt, (oh, ow))
        (got,) = torch.autograd.grad(y, xt, torch.tensor(g, dtype=dtype))
        xl = xt.detach().clone().requires_grad_()
        yl = torch.nn.functional.interpolate(xl, size=(oh, ow), mode="bilinear",
                                             align_corners=False)
        (lib,) = torch.autograd.grad(yl, xl, torch.tensor(g, dtype=dtype))
        assert torch.equal(y, yl)
        assert float((got - lib).abs().max()) <= tol * float(lib.abs().max())
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-5)


def test_without_cudnn_restores_the_setting():
    """The head's forward and ``train_step``'s backward turn cuDNN off and
    give the caller's setting back."""
    was = torch.backends.cudnn.enabled
    model = pseg.init_params(8, 8, 3, 4, torch.Generator().manual_seed(0), device="cpu")
    with pseg._without_cudnn():
        assert not torch.backends.cudnn.enabled
        model(torch.rand(16, 16, 3))
    assert torch.backends.cudnn.enabled == was
