"""Weight carry-over from the JAX package.

``clip_state_dict_from_jax`` turns the JAX package's CLIP parameter tree
(numpy arrays) into this package's ``state_dict``. It is the inverse of
``multimodal_tpu/utils/checkpoint.py:clip_params_from_torch``.
``long_context_lm_state_dict_from_jax`` does the same for the JAX
``LongContextLM`` (``multimodal_tpu/examples/long_context/model.py``),
``flava_state_dict_from_jax`` for ``FLAVAForPreTraining`` and
``FLAVAForClassification`` (``multimodal_tpu/models/flava/model.py``),
``dalle_state_dict_from_jax`` for its dVAE codebook
(``multimodal_tpu/models/flava/dalle_vae.py``) and
``clip_resnet_state_dict_from_jax`` for the ``clip_rn*`` models, the inverse
of ``multimodal_tpu/utils/checkpoint.py:clip_resnet_params_from_torch``, and
``albef_state_dict_from_jax`` for ALBEF (``ALBEFModelWithSimilarity``,
``ALBEFModelForRetrieval``, ``ALBEFModelForVQA``),
``videoclip_state_dict_from_jax`` for MUGEN's VideoCLIP
(``multimodal_tpu/examples/mugen``) and ``mdetr_state_dict_from_jax`` for
MDETR (``multimodal_tpu/models/mdetr``), and
``video_vqvae_state_dict_from_jax`` / ``video_gpt_state_dict_from_jax``
for the video VQ-VAE and VideoGPT's ``MultimodalGPT``
(``multimodal_tpu/models/video_gpt``, with either tokenizer of MUGEN's
text-to-video model).
Layouts:

- ``nn.Dense`` kernels are ``(in, out)``; ``nn.Linear`` weights ``(out, in)``;
- convolution kernels are HWIO in JAX and OIHW in torch
  (:func:`conv2d_weight_from_jax`), DHWIO and OIDHW in 3-D
  (:func:`conv3d_weight_from_jax`); flax's ``ConvTranspose`` kernel is
  DHWIO and unflipped, ``nn.ConvTranspose3d``'s IODHW and flipped
  (:func:`conv_transpose3d_weight_from_jax`);
- flax ``BatchNorm`` keeps ``scale`` / ``bias`` in ``params`` and ``mean`` /
  ``var`` in ``batch_stats``; ``Fp32BatchNorm2d`` has ``weight`` / ``bias``
  and the buffers ``running_mean`` / ``running_var``;
- ``Fp32LayerNorm`` parameters sit under ``LayerNorm_0`` in JAX, as
  ``scale`` / ``bias``;
- the fused ``in_proj`` holds ``[q | k | v]`` in both.

The map is linear (transposes and renames only), so it carries a JAX
gradient tree into the port's parameter names just as it carries weights;
the tests hold the port's gradients against ``jax.grad``'s that way.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    # arrays that JAX hands out are read-only; torch tensors never are
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def conv2d_weight_from_jax(kernel: Any) -> np.ndarray:
    """A flax 2-D convolution kernel (HWIO) in ``nn.Conv2d``'s layout (OIHW)."""
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def conv3d_weight_from_jax(kernel: Any) -> np.ndarray:
    """A flax 3-D convolution kernel (DHWIO) in ``nn.Conv3d``'s layout
    (OIDHW)."""
    return np.asarray(kernel).transpose(4, 3, 0, 1, 2)


def conv_transpose3d_weight_from_jax(kernel: Any) -> np.ndarray:
    """A flax 3-D transposed-convolution kernel (DHWIO, applied unflipped)
    in ``nn.ConvTranspose3d``'s layout (IODHW, applied flipped)."""
    return np.asarray(kernel).transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1].copy()


def _linear(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    out = {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])
    return out


def _fp32_layernorm(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    ln = p["LayerNorm_0"]
    return {f"{prefix}.weight": _t(ln["scale"]), f"{prefix}.bias": _t(ln["bias"])}


def _layernorm(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _encoder_stack(p: Mapping, prefix: str, n_layers: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_layers):
        lp = p[f"layer_{i}"]
        q = f"{prefix}.layers.{i}"
        out[f"{q}.self_attn.in_proj_weight"] = _t(np.asarray(lp["in_proj"]["kernel"]).T)
        out[f"{q}.self_attn.in_proj_bias"] = _t(lp["in_proj"]["bias"])
        out.update(_linear(lp["out_proj"], f"{q}.self_attn.out_proj"))
        out.update(_linear(lp["linear1"], f"{q}.linear1"))
        out.update(_linear(lp["linear2"], f"{q}.linear2"))
        out.update(_layernorm(lp["norm1"], f"{q}.norm1"))
        out.update(_layernorm(lp["norm2"], f"{q}.norm2"))
    return out


def clip_state_dict_from_jax(
    params: Mapping, n_vision_layers: int = 12, n_text_layers: int = 12
) -> Dict[str, torch.Tensor]:
    """JAX CLIP variables (``{"params": {"encoder_a": ..., "encoder_b": ...}}``,
    leaves as numpy arrays) -> this package's CLIP ``state_dict``."""
    p = params["params"] if "params" in params else params
    va, tb = p["encoder_a"], p["encoder_b"]
    sd: Dict[str, torch.Tensor] = {
        "encoder_a.conv.weight": _t(conv2d_weight_from_jax(va["conv"]["kernel"])),
        "encoder_a.cls_token_embedding": _t(va["cls_token_embedding"]),
        "encoder_a.positional_embedding": _t(va["positional_embedding"]),
        "encoder_a.projection": _t(va["projection"]),
    }
    sd.update(_fp32_layernorm(va["ln_pre"], "encoder_a.ln_pre"))
    sd.update(_encoder_stack(va["encoder"], "encoder_a.encoder", n_vision_layers))
    sd.update(_fp32_layernorm(va["ln_post"], "encoder_a.ln_post"))
    sd.update(_clip_text(tb, n_text_layers))
    return sd


def _clip_text(tb: Mapping, n_layers: int) -> Dict[str, torch.Tensor]:
    sd = {"encoder_b.token_embedding.weight": _t(tb["token_embedding"]["embedding"]),
          "encoder_b.positional_embedding": _t(tb["positional_embedding"])}
    sd.update(_encoder_stack(tb["encoder"], "encoder_b.encoder", n_layers))
    sd.update(_fp32_layernorm(tb["ln_final"], "encoder_b.ln_final"))
    sd.update(_linear(tb["projection"], "encoder_b.projection"))
    return sd


def clip_resnet_state_dict_from_jax(
    variables: Mapping, n_text_layers: int = 12
) -> Dict[str, torch.Tensor]:
    """JAX ResNet CLIP variables (``{"params": {"encoder_a": ...,
    "encoder_b": ...}, "batch_stats": {"encoder_a": ...}}``, leaves as numpy
    arrays) -> the ``state_dict`` of this package's ``clip_rn*`` models. The
    image tower carries the JAX names, so its parameters map by path
    (:func:`state_dict_from_jax_tree`); each BatchNorm's ``mean`` / ``var``
    become ``running_mean`` / ``running_var``."""
    p = variables["params"]
    sd = {f"encoder_a.{k}": v for k, v in state_dict_from_jax_tree(p["encoder_a"]).items()}
    sd.update(_batch_stats(variables["batch_stats"]["encoder_a"], "encoder_a"))
    sd.update(_clip_text(p["encoder_b"], n_text_layers))
    return sd


def long_context_lm_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``LongContextLM`` variables (``{"params": ...}`` or the bare
    tree, leaves as numpy arrays) -> this package's ``LongContextLM``
    ``state_dict``. The number of layers is read off the tree."""
    p = params["params"] if "params" in params else params
    dec = p["decoder"]
    sd: Dict[str, torch.Tensor] = {"tok_embed.weight": _t(p["tok_embed"]["embedding"])}
    if "pos_embed" in p:
        sd["pos_embed.weight"] = _t(p["pos_embed"]["embedding"])
    n_layer = sum(1 for k in dec if k.startswith("layer_"))
    for i in range(n_layer):
        lp = dec[f"layer_{i}"]
        q = f"decoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "output_proj"):
            sd.update(_linear(lp["attention"][proj], f"{q}.attention.{proj}"))
        sd.update(_fp32_layernorm(lp["attention_layernorm"], f"{q}.attention_layernorm"))
        sd.update(_linear(lp["feedforward"]["hidden_0"], f"{q}.feedforward.hidden_0"))
        sd.update(_linear(lp["feedforward"]["out"], f"{q}.feedforward.out"))
        sd.update(_fp32_layernorm(lp["feedforward_layernorm"], f"{q}.feedforward_layernorm"))
    sd.update(_fp32_layernorm(dec["final_layer_norm"], "decoder.final_layer_norm"))
    sd.update(_linear(p["lm_head"], "lm_head"))
    return sd


def state_dict_from_jax_tree(tree: Mapping, skip=()) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (leaves as numpy arrays) -> the ``state_dict`` of
    the port's module that carries the JAX module's names: the map is by
    path. ``layer_<i>`` is ``layers.<i>``, the ``LayerNorm_0`` level of
    ``Fp32LayerNorm`` goes, ``kernel`` / ``scale`` / ``embedding`` become
    ``weight`` (dense kernels transposed, convolution kernels HWIO -> OIHW
    and DHWIO -> OIDHW). Top-level entries named in ``skip`` are left out."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: List[str]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + [key])
                continue
            a = np.asarray(value)
            if key == "kernel":
                a = {4: conv2d_weight_from_jax, 5: conv3d_weight_from_jax}.get(
                    a.ndim, np.transpose)(a)
            name = "weight" if key in ("kernel", "scale", "embedding") else key
            parts = [re.sub(r"^layer_(\d+)$", r"layers.\1", k) for k in path
                     if k != "LayerNorm_0"]
            sd[".".join(parts + [name])] = _t(a)

    walk({k: v for k, v in tree.items() if k not in skip}, [])
    return sd


def dalle_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DalleVAEEncoder`` variables (``{"params": ...}`` or the bare
    tree, leaves as numpy arrays) -> this package's ``DalleVAEEncoder``
    ``state_dict``: by path, convolution kernels HWIO -> OIHW."""
    p = params["params"] if "params" in params else params
    return state_dict_from_jax_tree(p)


def flava_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``FLAVAForPreTraining`` or ``FLAVAForClassification`` variables
    (``{"params": ...}`` or the bare tree, leaves as numpy arrays) -> this
    package's ``state_dict`` (``state_dict_from_jax_tree``). The dVAE
    ``image_codebook`` goes through ``dalle_state_dict_from_jax``; a JAX
    tree initialised without ``image_for_codebook`` has none."""
    p = params["params"] if "params" in params else params
    sd = state_dict_from_jax_tree(p, skip=("image_codebook",))
    if "image_codebook" in p:
        sd.update({f"image_codebook.{k}": v
                   for k, v in dalle_state_dict_from_jax(p["image_codebook"]).items()})
    return sd


# JAX ALBEF parameter trees (``ALBEFModelWithSimilarity``,
# ``ALBEFModelForRetrieval``, ``ALBEFModelForVQA``, or a momentum tree onto
# the momentum copy's buffers) need nothing past the path map: dense kernels
# transposed, the patchify convolution HWIO -> OIHW.
albef_state_dict_from_jax = state_dict_from_jax_tree


def _batch_stats(stats: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax ``batch_stats`` (``mean`` / ``var`` under each BatchNorm's path)
    as the port's ``running_mean`` / ``running_var`` buffers."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: List[str]) -> None:
        for key, value in node.items():
            if key in ("mean", "var"):
                sd[".".join([*path, f"running_{key}"])] = _t(value)
            else:
                walk(value, path + [key])

    walk(stats, [prefix] if prefix else [])
    return sd


def videoclip_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``VideoCLIPForRetrieval`` or ``videoclip`` variables
    (``{"params": ..., "batch_stats": ...}``, leaves as numpy arrays) ->
    the ``state_dict`` of this package's counterpart
    (``examples/mugen/retrieval_train.py``, ``examples/mugen/video_clip.py``):
    by path, 3-D kernels DHWIO -> OIDHW, S3D's BatchNorm statistics as
    buffers. Without ``batch_stats`` (a gradient tree) only the parameters
    map."""
    sd = state_dict_from_jax_tree(variables["params"])
    sd.update(_batch_stats(variables.get("batch_stats", {})))
    return sd


def mdetr_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MDETR``, ``MDETRForPhraseGrounding`` or ``MDETRForVQA``
    variables (``{"params": ...}`` or the bare tree, leaves as numpy arrays)
    -> this package's ``state_dict`` (``models/mdetr/model.py``): by path,
    2-D kernels HWIO -> OIHW. ``FrozenBatchNorm2d``'s weight, bias and
    statistics, parameters under ``stop_gradient`` in JAX, are buffers
    here under the same names."""
    p = params["params"] if "params" in params else params
    return state_dict_from_jax_tree(p)


def _leaves(tree: Mapping, path: List[str] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, [*path, key])
        else:
            yield [*path, key], value


def video_vqvae_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX video VQ-VAE variables (``{"params": ..., "batch_stats": ...,
    "vq_stats": ...}``, leaves as numpy arrays) -> the ``state_dict`` of
    this package's ``VQVAE`` (``models/video_gpt/``): by path, convolution
    kernels DHWIO -> OIDHW, transposed ones flipped into IODHW, the
    BatchNorms' statistics and the codebook's ``vq_stats`` as buffers.
    Applied to a ``MultimodalGPT``'s variables it maps the whole model, both
    tokenizers included (:func:`video_gpt_state_dict_from_jax`)."""
    params = variables["params"] if "params" in variables else variables
    sd = state_dict_from_jax_tree(params)
    for path, value in _leaves(params):
        if path[-2:] == ["convt", "kernel"]:
            sd[".".join(path[:-1] + ["weight"])] = _t(conv_transpose3d_weight_from_jax(value))
    sd.update(_batch_stats(variables.get("batch_stats", {})))
    for path, value in _leaves(variables.get("vq_stats", {})):
        sd[".".join(path)] = _t(value)
    return sd


def video_gpt_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MultimodalGPT`` variables (VideoGPT's, or MUGEN's text-to-video
    model's) -> this package's ``MultimodalGPT`` ``state_dict``, both
    tokenizers included: ``layer_<i>`` is ``layers.<i>``, the text
    tokenizer's ``embedding_table`` an ``nn.Embedding``. The JAX model
    builds no parameters for a tokenizer part it never ran (the input
    VQ-VAE's decoder), so load with ``strict=False`` and check that the
    missing keys are only those."""
    return video_vqvae_state_dict_from_jax(variables)
