"""Reference `.pth` checkpoints read into the port.

Counterpart of `ei_nexus_tpu/models/port_torch.py`. The reference ships
trained checkpoints (`ckpts/MVSEC_EI_SP_LG_ft_Stage2.pth`, SuperPoint's
`superpoint_v1.pth`, SiLK's lightning `pvgg-4.ckpt`) whose state dicts
nest `event_extractor.extractor.*`, `image_extractor.extractor.*` and
`matcher.matcher.*`. Both sides are PyTorch, so conv weights keep their
OIHW layout and linear weights their (out, in) one; what changes is the
module names:
 - the VGG extractors (`VGGExtractor`, `VGGExtractorNP`): each block is
   Conv -> ReLU -> BN, so `backbone.l{s}.{i}.0` is the conv and `.2` the
   BatchNorm (absent without batchnorm); the heads' `_detH1`/`_desH1`
   are such a block and `_detH2`/`_desH2` a Conv (`.0`) -> BN (`.1`);
   here `backbone.l{s}_{i}.{conv,bn}`, `{detector,descriptor}_head.h1.
   {conv,bn}`, `.h2_conv`, `.h2_bn`;
 - SuperPoint v1 (`conv1a` ... `convDb`): the same names;
 - LightGlue: old-style `self_attn.{i}` / `cross_attn.{i}` become
   `transformers.{i}.self_attn` / `.cross_attn`, the FFN's `ffn.0/1/3`
   stay, and the reference's `token_confidence.{i}.token.0` becomes
   `token_confidence.{i}` (the port's head is a Linear named directly);
 - SiLK: `models/silk.py:load_silk_state_dict`.
Keys with no place in the port (`num_batches_tracked`) are dropped, and a
key the mapping expects but the file lacks raises KeyError. Every tensor
comes back as a float32 CPU tensor.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch
import torch.nn as nn

from .silk import load_silk_state_dict

_SUPERPOINT = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
               "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _tensor(value) -> torch.Tensor:
    return torch.as_tensor(value).detach().to(
        device="cpu", dtype=torch.float32).clone()


def _take(sd: Mapping[str, Any], src: str, dst: str, leaves,
          out: Dict[str, torch.Tensor]) -> None:
    for leaf in leaves:
        key = f"{src}.{leaf}"
        if key not in sd:
            raise KeyError(f"the state dict lacks {key!r}")
        out[f"{dst}.{leaf}"] = _tensor(sd[key])


def load_superpoint_torch_weights(state_dict: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """SuperPoint v1's state dict (`conv1a.weight` ... `convDb.bias`) ->
    the port's `SuperPointV1` state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name in _SUPERPOINT:
        _take(state_dict, name, name, ("weight", "bias"), out)
    return out


def load_vgg_extractor_torch_weights(state_dict: Mapping[str, Any],
                                     use_batchnorm: bool = True
                                     ) -> Dict[str, torch.Tensor]:
    """The reference VGGExtractor / VGGExtractorNP state dict -> the port's
    `VGGExtractor` state dict (four stages of two blocks, both heads)."""
    out: Dict[str, torch.Tensor] = {}
    for s in range(1, 5):
        for i in range(2):
            src, dst = f"backbone.l{s}.{i}", f"backbone.l{s}_{i}"
            _take(state_dict, f"{src}.0", f"{dst}.conv", ("weight", "bias"),
                  out)
            if use_batchnorm:
                _take(state_dict, f"{src}.2", f"{dst}.bn", _BN_LEAVES, out)
    for head, pre in (("detector_head", "_det"), ("descriptor_head", "_des")):
        src = f"{head}.{pre}"
        _take(state_dict, f"{src}H1.0", f"{head}.h1.conv", ("weight", "bias"),
              out)
        _take(state_dict, f"{src}H2.0", f"{head}.h2_conv", ("weight", "bias"),
              out)
        if use_batchnorm:
            _take(state_dict, f"{src}H1.2", f"{head}.h1.bn", _BN_LEAVES, out)
            _take(state_dict, f"{src}H2.1", f"{head}.h2_bn", _BN_LEAVES, out)
    return out


def load_lightglue_torch_weights(state_dict: Mapping[str, Any],
                                 n_layers: int = 9
                                 ) -> Dict[str, torch.Tensor]:
    """A reference LightGlue state dict -> the port's `LightGlue` state
    dict with every layer's assignment head and the L - 1 token-confidence
    heads (a model built with `training_heads=True` takes it strictly)."""
    sd = dict(state_dict)
    for i in range(n_layers):
        for old, new in ((f"self_attn.{i}.", f"transformers.{i}.self_attn."),
                         (f"cross_attn.{i}.",
                          f"transformers.{i}.cross_attn.")):
            sd = {(new + k[len(old):] if k.startswith(old) else k): v
                  for k, v in sd.items()}
    wb = ("weight", "bias")
    out: Dict[str, torch.Tensor] = {}
    _take(sd, "posenc.Wr", "posenc.Wr", ("weight",), out)
    if any(k.startswith("input_proj.") for k in sd):
        _take(sd, "input_proj", "input_proj", wb, out)
    for i in range(n_layers):
        t = f"transformers.{i}"
        for name in ("self_attn.Wqkv", "self_attn.out_proj",
                     "cross_attn.to_qk", "cross_attn.to_v",
                     "cross_attn.to_out"):
            _take(sd, f"{t}.{name}", f"{t}.{name}", wb, out)
        for block in ("self_attn", "cross_attn"):
            for j in (0, 1, 3):
                _take(sd, f"{t}.{block}.ffn.{j}", f"{t}.{block}.ffn.{j}", wb,
                      out)
        for name in ("final_proj", "matchability"):
            _take(sd, f"log_assignment.{i}.{name}",
                  f"log_assignment.{i}.{name}", wb, out)
        if i < n_layers - 1:
            _take(sd, f"token_confidence.{i}.token.0",
                  f"token_confidence.{i}", wb, out)
    return out


def _strip(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _prefixed(sd: Mapping[str, torch.Tensor], prefix: str
              ) -> Dict[str, torch.Tensor]:
    return {prefix + k: v for k, v in sd.items()}


def load_eim_torch_checkpoint(state_dict: Mapping[str, Any],
                              image_extractor_type: str = "superpointv1",
                              matcher_type: str = "LightGlue",
                              n_lightglue_layers: int = 9,
                              use_batchnorm: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """A whole reference EIM state dict -> the port's `EIM` state dict
    (`event_extractor.*`, `image_extractor.*` and, for LightGlue,
    `matcher.lightglue.*`); SiLK's `model.` nesting is taken off."""
    ev_sd = _strip(state_dict, "event_extractor.extractor.")
    im_sd = _strip(state_dict, "image_extractor.extractor.")
    ma_sd = _strip(state_dict, "matcher.matcher.")
    out = _prefixed(load_vgg_extractor_torch_weights(ev_sd, use_batchnorm),
                    "event_extractor.")
    if image_extractor_type == "superpointv1":
        out.update(_prefixed(load_superpoint_torch_weights(im_sd),
                             "image_extractor."))
    elif image_extractor_type == "silk":
        silk_sd = {re.sub(r"^model\.", "", k): v for k, v in im_sd.items()}
        out.update(_prefixed(load_silk_state_dict(silk_sd),
                             "image_extractor."))
    else:
        raise ValueError(image_extractor_type)
    if matcher_type == "LightGlue" and ma_sd:
        out.update(_prefixed(load_lightglue_torch_weights(
            ma_sd, n_layers=n_lightglue_layers), "matcher.lightglue."))
    return out


# the port's VGG names -> the reference's (the mapping above read backwards)
_VGG_BACK = (
    (r"^backbone\.l(\d)_(\d)\.conv\.", r"backbone.l\1.\2.0."),
    (r"^backbone\.l(\d)_(\d)\.bn\.", r"backbone.l\1.\2.2."),
    (r"^detector_head\.h1\.conv\.", "detector_head._detH1.0."),
    (r"^detector_head\.h1\.bn\.", "detector_head._detH1.2."),
    (r"^detector_head\.h2_conv\.", "detector_head._detH2.0."),
    (r"^detector_head\.h2_bn\.", "detector_head._detH2.1."),
    (r"^descriptor_head\.h1\.conv\.", "descriptor_head._desH1.0."),
    (r"^descriptor_head\.h1\.bn\.", "descriptor_head._desH1.2."),
    (r"^descriptor_head\.h2_conv\.", "descriptor_head._desH2.0."),
    (r"^descriptor_head\.h2_bn\.", "descriptor_head._desH2.1."),
)
# then SiLK's nesting (`SiLKVGG -> SharedBackboneMultipleHeads`)
_SILK_BACK = (
    (r"^backbone\.l(\d)\.",
     lambda m: f"model.backbone._backbone.layers.{int(m[1]) - 1}."),
    (r"^detector_head\.", "model.backbone._heads._mods.logits."),
    (r"^descriptor_head\.", "model.backbone._heads._mods.raw_descriptors."),
)


def _rename(key: str, rules) -> str:
    for pattern, repl in rules:
        key, n = re.subn(pattern, repl, key)
        if n:
            return key
    return key


def to_reference_layout(state_dict: Mapping[str, torch.Tensor],
                        image_extractor_type: str = "superpointv1"
                        ) -> Dict[str, torch.Tensor]:
    """The port's `EIM` state dict in the reference's `.pth` layout (what
    `load_eim_torch_checkpoint` reads back): the reference's nesting and
    module names, `token_confidence.{i}.token.0`, and a
    `num_batches_tracked` beside each BatchNorm's statistics."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        root, rest = key.split(".", 1)
        if root == "event_extractor":
            rest = _rename(rest, _VGG_BACK)
        elif root == "image_extractor" and image_extractor_type == "silk":
            rest = _rename(_rename(rest, _VGG_BACK), _SILK_BACK)
        elif root == "matcher":
            root, rest = "matcher.matcher", rest.split(".", 1)[1]
            rest = re.sub(r"^token_confidence\.(\d+)\.",
                          r"token_confidence.\1.token.0.", rest)
        if root in ("event_extractor", "image_extractor"):
            root += ".extractor"
        name = f"{root}.{rest}"
        out[name] = value.detach().cpu().clone()
        if name.endswith(".running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return out


def load_torch_file(path: str) -> Dict[str, Any]:
    """A `.pth` file's state dict on the CPU, unwrapped from a `model` or
    lightning `state_dict` entry. The reference's files hold more than
    tensors, so they are read with `weights_only=False`: read only files
    you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def load_silk_lightning_file(path: str) -> Dict[str, torch.Tensor]:
    """A SiLK pytorch-lightning checkpoint (the released `pvgg-4.ckpt`
    layout) -> the port's `SiLKVGG` state dict: the lightning `state_dict`
    wrapper and the `_mods.model.` prefix come off."""
    pre = "_mods.model."
    sd = {k[len(pre):] if k.startswith(pre) else k: v
          for k, v in load_torch_file(path).items()}
    return load_silk_state_dict(sd)


def load_eim_checkpoint_file(path: str, model: nn.Module,
                             image_extractor_type: str = "superpointv1",
                             matcher_type: str = "LightGlue",
                             n_lightglue_layers: int = 9,
                             use_batchnorm: bool = True) -> nn.Module:
    """Read a reference EIM checkpoint (`.pth`) into `model`, in place.

    Each root the file carries (`event_extractor`, `image_extractor`,
    `matcher`) replaces the model's: every tensor of the model under that
    root must come from the file (KeyError otherwise), and what the file
    holds beyond the model (the training heads, for a model built
    without them) is left out. Roots the file lacks (an MNN matcher has
    no parameters) keep their values, as the reference's
    `load_state_dict(..., strict=False)` does."""
    ported = load_eim_torch_checkpoint(
        load_torch_file(path), image_extractor_type=image_extractor_type,
        matcher_type=matcher_type, n_lightglue_layers=n_lightglue_layers,
        use_batchnorm=use_batchnorm)
    roots = {k.split(".")[0] for k in ported}
    want = [k for k in model.state_dict() if k.split(".")[0] in roots]
    missing = sorted(set(want) - set(ported))
    if missing:
        raise KeyError(f"the checkpoint lacks {missing[:5]}")
    model.load_state_dict({k: ported[k] for k in want}, strict=False)
    return model
