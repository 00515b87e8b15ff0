"""The port's training slice held against the JAX package: the contrastive
loss, the collectives' gradient semantics over gloo ranks, the fp32-master /
bf16-compute CLIP forward, and one and two train steps of a reduced CLIP
through the port's ``Trainer`` against ``jax.value_and_grad`` plus
``optax.adamw(1e-4)``.

Everything runs on the CPU, where the fused kernels' plain versions stand in
for the CUDA kernels. Inputs come from a numpy seed and go to both
frameworks as the same arrays.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from multimodal_tpu.models.clip.image_encoder import CLIPViTEncoder as JaxViT
from multimodal_tpu.models.clip.model import CLIP as JaxCLIP
from multimodal_tpu.models.clip.text_encoder import CLIPTextEncoder as JaxText
from multimodal_tpu.modules.losses import contrastive_loss_with_temperature as jloss
from multimodal_tpu.ops.image import fused_preprocess_for_encoder as jax_preprocess
from multimodal_tpu.parallel.collectives import BackpropType as JaxBackpropType
from multimodal_tpu_torch.models.clip.image_encoder import CLIPViTEncoder
from multimodal_tpu_torch.models.clip.model import CLIP
from multimodal_tpu_torch.models.clip.text_encoder import CLIPTextEncoder
from multimodal_tpu_torch.modules.losses.contrastive_loss_with_temperature import (
    ContrastiveLossWithTemperature,
    contrastive_loss_with_temperature,
)
from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder
from multimodal_tpu_torch.parallel.collectives import (
    BackpropType,
    all_gather_with_backprop_type,
    get_rank,
)
from multimodal_tpu_torch.training.trainer import Trainer
from multimodal_tpu_torch.utils.checkpoint import clip_state_dict_from_jax

# fp32 losses over a handful of rows: one framework against the other.
LOSS_ATOL = 1e-5
VISION = dict(embedding_dim=32, patch_size=16, image_size=64, width=128, heads=2, layers=2)
TEXT = dict(embedding_dim=32, context_length=77, vocab_size=1000, width=128,
            dim_feedforward=512, heads=2, layers=2)


def _embeddings(seed, n=6, d=16):
    r = np.random.RandomState(seed)
    a = r.randn(n, d).astype(np.float32)
    b = r.randn(n, d).astype(np.float32)
    norm = lambda t: t / np.linalg.norm(t, axis=-1, keepdims=True)
    return norm(a), norm(b)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_contrastive_loss_matches_jax(smoothing, masked):
    a, b = _embeddings(0)
    mask = np.array([1, 0, 1, 1, 0, 1], bool) if masked else None
    want = jloss.contrastive_loss_with_temperature(
        jnp.asarray(a), jnp.asarray(b), jnp.float32(2.3), None if mask is None
        else jnp.asarray(mask), label_smoothing=smoothing)
    got = contrastive_loss_with_temperature(
        torch.from_numpy(a), torch.from_numpy(b), 2.3,
        None if mask is None else torch.from_numpy(mask), label_smoothing=smoothing)
    for name in ("loss", "logits_a", "logits_b", "loss_a", "loss_b"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=LOSS_ATOL, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("init", [2.0, 6.0])  # inside, and above the ln(100) clamp
def test_contrastive_loss_module_matches_jax(init):
    a, b = _embeddings(1)
    module = jloss.ContrastiveLossWithTemperature(logit_scale_init=init)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))

    def jax_loss(v, a, b):
        return module.apply(v, a, b)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        variables, jnp.asarray(a), jnp.asarray(b))
    port = ContrastiveLossWithTemperature(logit_scale=init)
    at = torch.from_numpy(a).requires_grad_()
    got = port(at, torch.from_numpy(b))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=LOSS_ATOL)
    np.testing.assert_allclose(port.logit_scale.grad.item(),
                               float(want_grads[0]["params"]["logit_scale"]), atol=LOSS_ATOL)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want_grads[1]), atol=LOSS_ATOL)


def test_collectives_are_identity_without_a_process_group():
    x = torch.randn(3, 4)
    for bp in BackpropType:
        assert all_gather_with_backprop_type(x, None, bp) is x
    assert get_rank() == 0


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------

WORLD = 2


def _rank_worker(rank, port, a, b, out_dir):
    """One rank: the contrastive loss on its shard under each BackpropType;
    saves the loss and the gradients of its shard of a and b."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    n = a.shape[0] // WORLD
    rows = slice(rank * n, (rank + 1) * n)
    out = {}
    for bp in BackpropType:
        at = torch.from_numpy(a[rows]).requires_grad_()
        bt = torch.from_numpy(b[rows]).requires_grad_()
        loss = contrastive_loss_with_temperature(at, bt, 2.3, backprop_type=bp).loss
        loss.backward()
        out[f"{bp.name}_loss"] = loss.item()
        out[f"{bp.name}_ga"] = at.grad.numpy()
        out[f"{bp.name}_gb"] = bt.grad.numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_local_loss(a_all, b_all, rank, bp):
    """What one rank's loss is in the JAX package under ``shard_map``: its
    rows against the gathered rows, the other ranks' rows constant unless
    the gather is GLOBAL, and labels offset by ``rank * local_batch``."""
    n = a_all.shape[0] // WORLD
    a_loc = a_all[rank * n:(rank + 1) * n]
    b_loc = b_all[rank * n:(rank + 1) * n]
    if bp == BackpropType.GLOBAL:
        a_g, b_g = a_all, b_all
    elif bp == BackpropType.LOCAL:
        stop = jax.lax.stop_gradient
        a_g = stop(a_all).at[rank * n:(rank + 1) * n].set(a_loc)
        b_g = stop(b_all).at[rank * n:(rank + 1) * n].set(b_loc)
    else:
        a_g, b_g = jax.lax.stop_gradient(a_all), jax.lax.stop_gradient(b_all)
    labels = rank * n + jnp.arange(n)
    t = jnp.exp(jnp.float32(2.3))
    la = jloss.cross_entropy(a_loc @ b_g.T * t, labels)
    lb = jloss.cross_entropy(b_loc @ a_g.T * t, labels)
    return (la + lb) / 2


def test_all_gather_backprop_types_on_two_gloo_ranks(tmp_path):
    """GLOBAL: the ranks' mean loss is the JAX loss on the full batch, and
    its gradient through the reduce-scatter backward is the full-batch
    gradient of each rank's rows. LOCAL and NONE: each rank's gradient is
    the JAX local loss's with the gathered rows held constant where the JAX
    package holds them."""
    a, b = _embeddings(2, n=8)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_worker, args=(r, port, a, b, str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    n = a.shape[0] // WORLD
    aj, bj = jnp.asarray(a), jnp.asarray(b)

    full, (ga, gb) = jax.value_and_grad(
        lambda x, y: jloss.contrastive_loss_with_temperature(x, y, jnp.float32(2.3)).loss,
        argnums=(0, 1))(aj, bj)
    np.testing.assert_allclose(np.mean([g["GLOBAL_loss"] for g in got]), float(full),
                               atol=LOSS_ATOL)
    for r in range(WORLD):
        rows = slice(r * n, (r + 1) * n)
        # each rank's backward carries its own loss; DDP's mean over ranks
        # turns the summed reduce-scatter gradient into the full batch's
        np.testing.assert_allclose(got[r]["GLOBAL_ga"] / WORLD, np.asarray(ga)[rows],
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(got[r]["GLOBAL_gb"] / WORLD, np.asarray(gb)[rows],
                                   atol=LOSS_ATOL)
        for bp in (BackpropType.LOCAL, BackpropType.NONE):
            loss, (la, lb) = jax.value_and_grad(
                lambda x, y: _jax_local_loss(x, y, r, bp), argnums=(0, 1))(aj, bj)
            np.testing.assert_allclose(got[r][f"{bp.name}_loss"], float(loss), atol=LOSS_ATOL)
            np.testing.assert_allclose(got[r][f"{bp.name}_ga"], np.asarray(la)[rows],
                                       atol=LOSS_ATOL, err_msg=bp.name)
            np.testing.assert_allclose(got[r][f"{bp.name}_gb"], np.asarray(lb)[rows],
                                       atol=LOSS_ATOL, err_msg=bp.name)
    assert {bp.name for bp in BackpropType} == {bp.name for bp in JaxBackpropType}


# --------------------------------------------------------------------------
# the reduced CLIP: mixed precision and the train step
# --------------------------------------------------------------------------


def _token_ids(r, n):
    ids = r.randint(1, 998, size=(n, 77)).astype(np.int32)
    for i, length in enumerate(r.randint(3, 76, size=n)):
        ids[i, length] = 999  # EOT: the highest id
        ids[i, length + 1:] = 0
    return ids


def _jax_variables(dtype=jnp.float32):
    model = JaxCLIP(JaxViT(**VISION, dtype=dtype), JaxText(**TEXT, dtype=dtype))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                           jnp.zeros((1, 77), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port(variables, dtype=None):
    port = CLIP(CLIPViTEncoder(**VISION, dtype=dtype), CLIPTextEncoder(**TEXT, dtype=dtype))
    port.load_state_dict(clip_state_dict_from_jax(variables, 2, 2), strict=True)
    return port


def test_fp32_params_bf16_compute_matches_jax():
    """fp32 master weights cast to bf16 at use, in both frameworks. The two
    round at different points (bias adds, the fused kernels' plain versions
    against the XLA path), so after two layers a row moves by a few bf16
    units; the bar is a per-row cosine of 0.999 and 2**-5 absolute on unit
    vectors of width 32."""
    jax_model, variables = _jax_variables(jnp.bfloat16)
    port = _port(variables, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    r = np.random.RandomState(3)
    images = r.randn(3, 64, 64, 3).astype(np.float32)
    ids = _token_ids(r, 3)
    want = jax_model.apply(variables, jnp.asarray(images), jnp.asarray(ids))
    with torch.no_grad():
        got = port(torch.from_numpy(images), torch.from_numpy(ids))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        w = np.asarray(w).astype(np.float32)
        cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1))
        assert cos.min() > 0.999
        np.testing.assert_allclose(g, w, atol=2.0 ** -5)


def _batches(n_steps, batch=4, seed=4):
    r = np.random.RandomState(seed)
    return [(r.randint(0, 256, size=(batch, 80, 80, 3)).astype(np.uint8), _token_ids(r, batch))
            for _ in range(n_steps)]


def _jax_loss_fn(model):
    """bench.py's loss_fn at the reduced image size and in fp32."""

    def loss_fn(params, images_u8, text):
        pixels = jax_preprocess(images_u8, 64, dtype=jnp.float32)
        out = model.apply(params, pixels, text)
        return jloss.contrastive_loss_with_temperature(
            out.embeddings_a, out.embeddings_b, jnp.float32(4.6052)).loss

    return loss_fn


def _port_loss_fn(model, batch):
    images_u8, text = batch
    out = model(fused_preprocess_for_encoder(images_u8, 64, dtype=torch.float32), text)
    return contrastive_loss_with_temperature(
        out.embeddings_a, out.embeddings_b, 4.6052).loss, {}


def _adamw(model):
    # optax.adamw(1e-4): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
    # every parameter (torch's default would be 1e-2)
    return torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _state(tree):
    return {k: v.numpy() for k, v in clip_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), 2, 2).items()}


# fp32 through two reduced towers and the contrastive loss at temperature
# 100, whose gradients reach about 10. Gradients: the same arithmetic, sums
# in another order, so 1e-5 of each tensor's own scale. Updated parameters:
# 1e-6 absolute plus 5% of lr where the gradient stands above that noise
# floor. Below it (the key part of in_proj_bias, whose true gradient is 0:
# softmax ignores a constant added to a row) Adam's early steps move a
# weight by up to lr in a direction set by rounding, so such weights are
# held to that bound, lr a step.
LR = 1e-4
GRAD_REL = 1e-5
PARAM_ATOL = 1e-6 + 0.05 * LR


def test_train_steps_match_jax_value_and_grad_and_adamw():
    """The slice as a whole: the loss, every gradient (carried into the
    port's names by the same linear map as the weights) and every updated
    parameter after one and two steps of the port's Trainer."""
    jax_model, variables = _jax_variables()
    port = _port(variables)
    batches = _batches(2)
    loss_fn = _jax_loss_fn(jax_model)
    opt = optax.adamw(LR)
    params, opt_state = variables, opt.init(variables)
    trainer = Trainer(_port_loss_fn, _adamw(port), device="cpu", log_interval=1)
    for step, batch in enumerate(batches, start=1):
        loss, grads = jax.value_and_grad(loss_fn)(params, *map(jnp.asarray, batch))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        trainer.fit(port, [batch], 1)
        assert trainer.step == step
        np.testing.assert_allclose(trainer.logger.records[-1]["loss"], float(loss), atol=1e-5)
        want_grads, want = _state(grads), _state(params)
        for name, p in port.named_parameters():
            g = want_grads[name]
            floor = GRAD_REL * max(1.0, float(np.abs(g).max()))
            np.testing.assert_allclose(p.grad.numpy(), g, atol=floor,
                                       err_msg=f"step {step} grad {name}")
            got = p.detach().numpy()
            above = np.abs(g) > floor
            np.testing.assert_allclose(got[above], want[name][above], atol=PARAM_ATOL,
                                       err_msg=f"step {step} param {name}")
            np.testing.assert_allclose(got[~above], want[name][~above],
                                       atol=2 * LR * step + PARAM_ATOL,
                                       err_msg=f"step {step} param {name} (noise-level grad)")


class _Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


def _linear_problem(n_batches, bad=()):
    """A least-squares problem small enough to run through optax by hand;
    batches listed in ``bad`` carry a NaN."""
    r = np.random.RandomState(5)
    w = r.randn(4, 3).astype(np.float32)
    batches = []
    for i in range(n_batches):
        x = r.randn(5, 4).astype(np.float32)
        y = r.randn(5, 3).astype(np.float32)
        if i in bad:
            x[0, 0] = np.nan
        batches.append((x, y))
    return w, batches


def _port_linear(w, batches, **kw):
    model = _Linear(w)
    trainer = Trainer(lambda m, b: (((b[0] @ m.w - b[1]) ** 2).mean(), {}),
                      _adamw(model), device="cpu", log_interval=100, **kw)
    trainer.fit(model, batches, len(batches))
    return model.w.detach().numpy(), trainer.logger.records


def _optax_linear(w, batches, opt):
    loss = lambda w, x, y: jnp.mean((x @ w - y) ** 2)
    w = jnp.asarray(w)
    state = opt.init(w)
    for x, y in batches:
        g = jax.grad(loss)(w, jnp.asarray(x), jnp.asarray(y))
        updates, state = opt.update(g, state, w)
        w = optax.apply_updates(w, updates)
    return np.asarray(w)


def test_grad_accum_steps_matches_optax_multisteps():
    w, batches = _linear_problem(4)
    got, _ = _port_linear(w, batches, grad_accum_steps=2)
    want = _optax_linear(w, batches, optax.MultiSteps(optax.adamw(1e-4), every_k_schedule=2))
    np.testing.assert_allclose(got, want, atol=1e-6)
    half, _ = _port_linear(w, batches[:1], grad_accum_steps=2)
    np.testing.assert_array_equal(half, w)  # no update before the k-th step


@pytest.mark.parametrize("accum", [1, 2])
def test_skip_nonfinite_updates_drops_the_step(accum):
    """As the JAX Trainer: a step with a non-finite loss or gradient leaves
    parameters, optimizer state and accumulation as they were, so the run
    equals the same run without that batch."""
    w, batches = _linear_problem(5, bad=(1,))
    got, records = _port_linear(w, batches, skip_nonfinite_updates=True, grad_accum_steps=accum)
    assert [r["nonfinite_skipped"] for r in records] == [0.0, 1.0, 0.0, 0.0, 0.0]
    opt = optax.adamw(1e-4)
    if accum > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accum)
    want = _optax_linear(w, [b for i, b in enumerate(batches) if i != 1], opt)
    np.testing.assert_allclose(got, want, atol=1e-6)
