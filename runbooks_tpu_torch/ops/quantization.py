"""Blockwise weight-only quantization (int8 / packed int4) and the int8 KV
helpers (the port of ``runbooks_tpu.ops.quantization``).

Scheme (weight-only, symmetric, blockwise along the contraction axis), as
the reference's:

- A weight ``w`` of shape ``[..., in, out]`` splits into ``in/block_size``
  blocks along ``in``; each (block, out-channel) gets one f32 scale
  ``amax/qmax`` and stores ``round(w/scale)`` (half to even) as int8
  (int4: two nibbles packed per byte along ``in``, so the packed tensor is
  ``[..., in/2, out]``).
- ``quantized_matmul`` computes ``sum_b s_b * (x_b . q_b)``: each block's
  partial dot is an f32 product of exactly representable f32 operands
  (the activation-dtype x and the integer codes widened to f32), and the
  scale-weighted partials sum in f32. Rows are chunked so the
  ``[rows, in/bs, out]`` f32 partial stays bounded.
- Activations stay in the model's activation dtype; only the attention
  and dense-MLP matrices (``QUANTIZABLE_KEYS``) and, optionally, the
  serving KV cache are quantized. The int8 KV cache keeps one f32 scale
  per (token, kv head) row beside its int8 values: ``quantize_kv`` is the
  write half, ``dequantize_kv`` the read half.

``QuantizedArray`` is a leaf of the port's param trees (utils/tree.py
treats anything but a dict as one). It indexes along its leading layer
axis and moves between devices with ``.to``, which is all the eager
forward asks of a weight. ``quantize_params`` quantizes a tree in place,
one stacked leaf at a time and one layer slice at a time on the leaf's
device, dropping each source leaf as its packed form lands, so a load
holds about one f32 layer above the packed size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

QUANTIZE_MODES = ("none", "int8", "int4")

# Param-tree keys eligible for weight-only quantization: the big matmuls of
# the attention and dense-MLP blocks. Norm scales, embeddings and the LM
# head stay in the param dtype.
QUANTIZABLE_KEYS = {
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("wi", "wi_gate", "wi_up", "wo"),
}

# The checkpoint marker of a packed leaf (pack_for_checkpoint).
_QMARK = "__quantized__"

# Bytes of the f32 [rows, in/bs, out] partial quantized_matmul builds at
# once; more rows go through in chunks (the same sums).
PARTIAL_BYTES = 1 << 28


@dataclasses.dataclass
class QuantizedArray:
    """Blockwise-quantized weight of logical shape ``[..., in, out]``.

    values: int8 ``[..., in, out]`` (bits=8) or uint8 ``[..., in/2, out]``
        (bits=4: in-axis pairs (2i, 2i+1) packed low/high nibble).
    scales: f32 ``[..., in/block_size, out]``, one per (block, out-channel).
    """

    values: torch.Tensor
    scales: torch.Tensor
    bits: int = 8
    block_size: int = 128

    @property
    def in_dim(self) -> int:
        mult = 2 if self.bits == 4 else 1
        return self.values.shape[-2] * mult

    @property
    def shape(self) -> Tuple[int, ...]:
        """The logical (unpacked) shape."""
        return (*self.values.shape[:-2], self.in_dim, self.values.shape[-1])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.scales))

    def numel(self) -> int:
        """Logical parameter count (the pre-packing weight's)."""
        n = 1
        for d in self.shape:
            n *= d
        return n

    def __getitem__(self, idx) -> "QuantizedArray":
        """A slice along the leading (layer) axes: ``w[layer]``."""
        if self.values.dim() <= 2:
            raise IndexError("a per-layer [in, out] QuantizedArray has no "
                             "leading axis to index")
        return QuantizedArray(values=self.values[idx],
                              scales=self.scales[idx], bits=self.bits,
                              block_size=self.block_size)

    def to(self, device, copy: bool = False) -> "QuantizedArray":
        return QuantizedArray(values=self.values.to(device, copy=copy),
                              scales=self.scales.to(device, copy=copy),
                              bits=self.bits, block_size=self.block_size)


def _qmax(bits: int) -> int:
    # Symmetric ranges: +-127 (int8), +-7 (int4: the -8 code is unused so
    # negation is exact and pack/unpack stays symmetric).
    return 127 if bits == 8 else 7


def _over(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as one IEEE division, as the reference's is. (On CUDA
    a Python-number divisor becomes a multiply by its reciprocal, which
    can differ in the last bit and so move a code.)"""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def resolve_block_size(in_dim: int, block_size: int, bits: int) -> int:
    """Largest usable block <= block_size that divides in_dim (int4 also
    needs an even block so nibble pairs never straddle blocks)."""
    bs = min(block_size, in_dim)
    while bs > 1 and (in_dim % bs != 0 or (bits == 4 and bs % 2 != 0)):
        bs -= 1
    if bits == 4 and in_dim % 2 != 0:
        raise ValueError(f"int4 needs an even contraction dim, got {in_dim}")
    return max(bs, 1)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., in, out] int8 in [-7, 7] -> [..., in/2, out] uint8 (low nibble
    = even in-index, high nibble = odd)."""
    u = q.to(torch.int32) & 0xF
    lo, hi = u[..., 0::2, :], u[..., 1::2, :]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: [..., in/2, out] uint8 -> [..., in, out] int8."""
    p = packed.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    both = torch.stack([lo, hi], dim=-2)                 # [..., in/2, 2, out]
    flat = both.reshape(*packed.shape[:-2], -1, packed.shape[-1])
    return torch.where(flat > 7, flat - 16, flat).to(torch.int8)


def quantize(w: torch.Tensor, bits: int = 8,
             block_size: int = 128) -> QuantizedArray:
    """Blockwise symmetric quantization of ``[..., in, out]`` along ``in``,
    on w's device."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    *lead, in_dim, out = w.shape
    bs = resolve_block_size(in_dim, block_size, bits)
    nb = in_dim // bs
    wb = w.to(torch.float32).reshape(*lead, nb, bs, out)
    scales = _over(wb.abs().amax(dim=-2), _qmax(bits))  # [..., nb, out]
    safe = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(wb / safe[..., None, :]), -_qmax(bits),
                    _qmax(bits))
    q = q.reshape(*lead, in_dim, out).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return QuantizedArray(values=q, scales=scales, bits=bits, block_size=bs)


def _codes(qa: QuantizedArray) -> torch.Tensor:
    return unpack_int4(qa.values) if qa.bits == 4 else qa.values


def dequantize(qa: QuantizedArray, dtype=torch.float32) -> torch.Tensor:
    """The full weight (tests and yardsticks; the forward never calls
    this, see quantized_matmul)."""
    q = _codes(qa)
    *lead, in_dim, out = q.shape
    nb = in_dim // qa.block_size
    wb = q.to(torch.float32).reshape(*lead, nb, qa.block_size, out)
    w = wb * qa.scales[..., None, :]
    return w.reshape(*lead, in_dim, out).to(dtype)


def quantized_matmul(x: torch.Tensor, qa: QuantizedArray,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x[..., in] @ w[in, out]`` as ``sum_b s_b * (x_b . q_b)``: x rounds
    to compute_dtype (the reference's operand cast), both operands widen
    to f32, which holds them exactly, each block's partial dot is an f32
    product (TF32 must be off on the card, as chip_smoke.py sets it), and
    the scale-weighted partials sum in f32. Returns f32 [..., out]."""
    if qa.values.dim() != 2:
        raise ValueError(
            "quantized_matmul wants a per-layer [in, out] weight; got "
            f"{tuple(qa.values.shape)} (index the layer first)")
    q = _codes(qa)
    in_dim, out = q.shape
    bs = qa.block_size
    nb = in_dim // bs
    lead = x.shape[:-1]
    xf = x.to(compute_dtype).to(torch.float32).reshape(-1, nb, bs)
    wb = q.to(torch.float32).reshape(nb, bs, out)
    rows = xf.shape[0]
    chunk = max(1, PARTIAL_BYTES // (nb * out * 4))
    parts = []
    for r0 in range(0, rows, chunk):
        xb = xf[r0:r0 + chunk].transpose(0, 1)           # [nb, r, bs]
        partial = torch.bmm(xb, wb)                      # [nb, r, out]
        parts.append((partial * qa.scales[:, None, :]).sum(dim=0))
    y = parts[0] if len(parts) == 1 else torch.cat(parts)
    return y.reshape(*lead, out)


# ---------------------------------------------------------------------------
# Model param trees
# ---------------------------------------------------------------------------

def resolve_quantize_mode(params_cfg: Dict[str, Any], cfg=None) -> str:
    """One resolution rule for the `quantize` contract param, shared by the
    loader workload and the serving entry point: the params value wins,
    else the ModelConfig field, else "none"; anything outside
    QUANTIZE_MODES raises."""
    default = getattr(cfg, "quantize", "none") if cfg is not None else "none"
    mode = str(params_cfg.get("quantize", default) or "none")
    if mode not in QUANTIZE_MODES:
        raise ValueError(
            f"unknown quantize mode {mode!r}; expected one of "
            f"{'|'.join(QUANTIZE_MODES)}")
    return mode


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def tree_quantize_mode(params) -> str:
    """The mode a param tree is quantized at ("none" when it holds no
    QuantizedArray leaves)."""
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedArray):
            return "int8" if leaf.bits == 8 else "int4"
    return "none"


def mode_bits(mode: str) -> int:
    """8 or 4 for a quantized mode; raises for an unknown one."""
    if mode not in QUANTIZE_MODES or mode == "none":
        raise ValueError(
            f"unknown quantize mode {mode!r}; expected one of "
            f"{'|'.join(QUANTIZE_MODES[1:])}")
    return 8 if mode == "int8" else 4


def quantize_params(params: Dict[str, Any], mode: str,
                    block_size: int = 128) -> Dict[str, Any]:
    """Quantize a transformer param tree's big matmuls in place (returns
    the same tree object), each on its own device. A caller that keeps the
    unquantized tree passes a copy of its dicts
    (``utils.tree.tree_map(lambda t: t, params)``)."""
    if mode not in QUANTIZE_MODES:
        raise ValueError(
            f"unknown quantize mode {mode!r}; expected one of "
            f"{'|'.join(QUANTIZE_MODES)}")
    if mode == "none":
        return params
    bits = mode_bits(mode)
    layers = params.get("layers", {})
    for group, keys in QUANTIZABLE_KEYS.items():
        sub = layers.get(group)
        if not isinstance(sub, dict):
            continue
        for key in keys:
            w = sub.get(key)
            if w is None or isinstance(w, QuantizedArray):
                continue
            # The source leaf is freed once its packed form replaces it
            # (unless the caller holds it elsewhere).
            sub[key] = _quantize_stacked(w, bits, block_size)
            w = None
    return params


def _quantize_stacked(w: torch.Tensor, bits: int,
                      block_size: int) -> QuantizedArray:
    """Quantize ``[L, in, out]`` (or ``[in, out]``) one leading slice at a
    time (quantize_stack)."""
    if w.dim() == 2:
        return quantize(w, bits, block_size)
    if w.dim() != 3:
        raise ValueError(
            f"expected [L, in, out] or [in, out], got {tuple(w.shape)}")
    return quantize_stack(lambda layer: w[layer], w.shape[0], bits,
                          block_size)


def quantize_stack(layer: Callable[[int], torch.Tensor], num_layers: int,
                   bits: int, block_size: int = 128) -> QuantizedArray:
    """A stacked ``[L, in, out]`` weight quantized layer by layer into
    preallocated packed stacks on the first layer's device: ``layer(l)``
    gives layer l's ``[in, out]`` weight, so at most one layer's f32
    transient lives beside the packed result (the import converts each HF
    layer straight into its packed form this way)."""
    first = layer(0)
    in_dim, out = first.shape
    bs = resolve_block_size(in_dim, block_size, bits)
    rows = in_dim // 2 if bits == 4 else in_dim
    vals = torch.empty((num_layers, rows, out),
                       dtype=torch.uint8 if bits == 4 else torch.int8,
                       device=first.device)
    scs = torch.empty((num_layers, in_dim // bs, out), dtype=torch.float32,
                      device=first.device)
    for li in range(num_layers):
        qa = quantize(first if li == 0 else layer(li), bits, bs)
        first = None
        vals[li].copy_(qa.values)
        scs[li].copy_(qa.scales)
    return QuantizedArray(values=vals, scales=scs, bits=bits, block_size=bs)


def quantized_logical_axes(params: Dict[str, Any],
                           axes: Dict[str, Any]) -> Dict[str, Any]:
    """Rewrite a ``param_logical_axes`` tree so positions holding a
    QuantizedArray get a QuantizedArray of axis tuples (the reference's):
    values keep the weight's axes, the scales' block axis replicates.
    (The serving plan cuts a QuantizedArray by whole blocks instead,
    parallel/sharding.shard_leaf.)"""
    def fix(p, a):
        if isinstance(p, dict):
            return {k: fix(p[k], a[k]) for k in p}
        if isinstance(p, QuantizedArray):
            scale_axes = tuple(a[:-2]) + (None, a[-1])
            return QuantizedArray(values=a, scales=scale_axes,
                                  bits=p.bits, block_size=p.block_size)
        return a

    return fix(params, axes)


# ---------------------------------------------------------------------------
# Checkpoint round trip: plain dicts of tensors, so torch.load
# (weights_only=True) restores a packed tree with no custom class
# ---------------------------------------------------------------------------

def pack_for_checkpoint(tree):
    """QuantizedArray leaves -> {"__quantized__": {"values", "scales",
    "meta": int32 [bits, block_size]}}; other leaves unchanged."""
    if isinstance(tree, dict):
        return {k: pack_for_checkpoint(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedArray):
        return {_QMARK: {
            "values": tree.values, "scales": tree.scales,
            "meta": torch.tensor([tree.bits, tree.block_size],
                                 dtype=torch.int32)}}
    return tree


def _is_marker(x) -> bool:
    return isinstance(x, dict) and set(x) == {_QMARK}


def unpack_from_checkpoint(tree):
    """Inverse of pack_for_checkpoint (no-op on unquantized trees)."""
    if _is_marker(tree):
        inner = tree[_QMARK]
        bits, bs = (int(v) for v in inner["meta"].tolist())
        return QuantizedArray(values=inner["values"],
                              scales=inner["scales"], bits=bits,
                              block_size=bs)
    if isinstance(tree, dict):
        return {k: unpack_from_checkpoint(v) for k, v in tree.items()}
    return tree


def tree_weight_bytes(params) -> int:
    """Total parameter bytes (a QuantizedArray counts its packed values and
    scales): the number the serving memory math cares about."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedArray):
            total += leaf.nbytes
        else:
            total += leaf.numel() * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., head_dim] activations -> (int8 values, f32 scales [...]) with
    one symmetric scale per (token, head) row: the KV cache's write half."""
    xf = x.to(torch.float32)
    scale = _over(xf.abs().amax(dim=-1), 127.0)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """The cache's read half: int8 [..., d] * f32 scale [...] -> dtype."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)
