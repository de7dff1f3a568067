"""Versioned KV-block wire format, RTKV (counterpart of
``ray_tpu/serve/llm/kv_transfer.py``, without its object-store id).

The host KV tier keeps each demoted block as one record of this format,
and ``LLMEngine.export_prefix`` / ``adopt_prefix`` move blocks between
engines in it. Wire layout (all integers little-endian):

    MAGIC   4 bytes   b"RTKV"
    VERSION u16       wire version (bump on any layout change)
    HLEN    u32       length of the JSON header that follows
    HEADER  HLEN      json: {n_layer, block_size, n_kv_head, head_dim,
                             dtype, num_blocks, prefix_tokens}
                      v2 (quantized pools) adds: {quantization,
                             scale_dtype}; dtype is then the QUANTIZED
                             storage dtype (int8 / float8_e4m3fn)
    then, per block, in chain order:
      CHAIN   16 bytes  blake2b-16 token-chain digest
                        (``kv_cache._block_key``): which tokens from
                        position 0 the block encodes
      CONTENT 16 bytes  blake2b-16 over the payload bytes below
      v1:  K || V       each n_layer*block_size*n_kv_head*head_dim
                        * itemsize bytes
      v2:  K || KS || V || VS   quantized data planes plus their
                        [n_layer, block_size, n_kv_head] scale planes

``head_dim`` is the model's: the pool's padding columns
(``ops/kv_cache.pool_head_dim``) never travel. Any layout, digest or size
mismatch raises ``KVTransferError``, which callers treat as a miss.

Payloads are numpy arrays. bfloat16 and float8-e4m3 have no numpy dtype
without the JAX package's ``ml_dtypes``, so this module holds them as
``uint16`` / ``uint8`` views of the same bytes (``storage_dtype``), while
the header names the dtype as the JAX package does (``"bfloat16"``,
``"float8_e4m3fn"``): a record from the port is byte-identical to the
JAX package's for the same values. The module is device-free.
"""
from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass

import numpy as np

from ray_tpu_torch.ops.quantization import QuantizedKV

MAGIC = b"RTKV"
WIRE_VERSION = 1        # plain pools
WIRE_VERSION_QUANT = 2  # quantized pools (adds scale planes + header fields)
_DIGEST = 16  # blake2b digest_size, matches kv_cache._block_key
_HDR = struct.Struct("<4sHI")

# dtype name on the wire -> the numpy dtype that holds its bytes here
_STORAGE = {
    "float32": np.float32, "float16": np.float16, "bfloat16": np.uint16,
    "int8": np.int8, "float8_e4m3fn": np.uint8,
}


class KVTransferError(RuntimeError):
    """A KV payload failed validation (layout / digest / size). Treated
    like a lost block: recompute rather than read suspect bytes."""


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a wire dtype's bytes."""
    try:
        return np.dtype(_STORAGE[name])
    except KeyError:
        raise KVTransferError(f"unsupported KV dtype {name!r}") from None


def dtype_name(dtype) -> str:
    """The wire name of a torch dtype (``torch.bfloat16`` -> "bfloat16")."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class KVLayout:
    """Tensor layout a payload was packed under. Both sides must agree
    exactly: blocks from another model or dtype are not landable."""

    n_layer: int
    block_size: int
    n_kv_head: int
    head_dim: int
    dtype: str
    # quantized pools: the kind ("int8" | "fp8") and the scale plane's
    # dtype. None => v1 payloads.
    quantization: str | None = None
    scale_dtype: str = "float32"

    @property
    def block_bytes(self) -> int:
        """One side's DATA bytes per block (in ``dtype``: the quantized
        storage dtype for v2 layouts)."""
        n = self.n_layer * self.block_size * self.n_kv_head * self.head_dim
        return n * storage_dtype(self.dtype).itemsize

    @property
    def scale_bytes(self) -> int:
        """One side's scale-plane bytes per block (0 for plain pools)."""
        if self.quantization is None:
            return 0
        n = self.n_layer * self.block_size * self.n_kv_head
        return n * storage_dtype(self.scale_dtype).itemsize

    @property
    def record_payload_bytes(self) -> int:
        """K + V (+ scale planes) bytes per block record on the wire."""
        return 2 * (self.block_bytes + self.scale_bytes)

    @property
    def record_bytes(self) -> int:
        """One block's record on the wire: digests and payload."""
        return 2 * _DIGEST + self.record_payload_bytes


def _raw(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _record_payload(layout: KVLayout, k_block, v_block) -> bytes:
    """One record's payload per the layout's version: v1 is K||V; v2
    (quantized) is K||KS||V||VS, each scale plane beside its data."""
    if layout.quantization is None:
        return _raw(k_block) + _raw(v_block)
    if not isinstance(k_block, QuantizedKV):
        raise KVTransferError(
            f"layout says quantization={layout.quantization!r} but the "
            f"block payload is a plain {type(k_block).__name__}"
        )
    return (_raw(k_block.data) + _raw(k_block.scale)
            + _raw(v_block.data) + _raw(v_block.scale))


def pack_blocks(layout: KVLayout, records: list, *,
                prefix_tokens: int) -> bytes:
    """Pack ``records``, (chain_digest, k_block, v_block) in chain order,
    into one wire payload. Each k/v block is [n_layer, block_size,
    n_kv_head, head_dim]; for a quantized layout a ``QuantizedKV`` whose
    scale plane drops the head_dim axis, and the wire is version 2."""
    header = {
        "n_layer": layout.n_layer,
        "block_size": layout.block_size,
        "n_kv_head": layout.n_kv_head,
        "head_dim": layout.head_dim,
        "dtype": layout.dtype,
        "num_blocks": len(records),
        "prefix_tokens": prefix_tokens,
    }
    version = WIRE_VERSION
    if layout.quantization is not None:
        version = WIRE_VERSION_QUANT
        header["quantization"] = layout.quantization
        header["scale_dtype"] = layout.scale_dtype
    hjson = json.dumps(header, sort_keys=True).encode()
    parts = [_HDR.pack(MAGIC, version, len(hjson)), hjson]
    for chain_digest, k_block, v_block in records:
        if len(chain_digest) != _DIGEST:
            raise KVTransferError(
                f"chain digest must be {_DIGEST} bytes, got "
                f"{len(chain_digest)}"
            )
        payload = _record_payload(layout, k_block, v_block)
        if len(payload) != layout.record_payload_bytes:
            raise KVTransferError(
                f"block payload is {len(payload)} bytes, layout says "
                f"{layout.record_payload_bytes}"
            )
        parts.append(chain_digest)
        parts.append(hashlib.blake2b(payload, digest_size=_DIGEST).digest())
        parts.append(payload)
    return b"".join(parts)


def _check_layout_match(layout: KVLayout, expect: KVLayout) -> None:
    """Raise a ``KVTransferError`` naming every field on which a payload's
    layout disagrees with the pool that would land it."""
    if layout == expect:
        return
    diffs = []
    for f in ("n_layer", "block_size", "n_kv_head", "head_dim", "dtype",
              "quantization", "scale_dtype"):
        got, want = getattr(layout, f), getattr(expect, f)
        if got != want:
            diffs.append(f"{f}: payload={got!r} pool={want!r}")
    raise KVTransferError(
        "KV payload layout does not match this pool (" + "; ".join(diffs)
        + ")"
    )


def unpack_blocks(wire: bytes, *, expect: KVLayout | None = None):
    """Parse and verify a wire payload (versions 1 and 2) ->
    (layout, prefix_tokens, records), records being (chain_digest,
    k_block, v_block) in chain order: numpy arrays of ``storage_dtype``
    for v1, ``QuantizedKV`` of numpy arrays for v2. ``expect`` (the
    landing pool's layout) turns a config mismatch into a field-naming
    error before any bytes are reinterpreted."""
    if len(wire) < _HDR.size:
        raise KVTransferError("payload shorter than wire header")
    magic, version, hlen = _HDR.unpack_from(wire, 0)
    if magic != MAGIC:
        raise KVTransferError(f"bad magic {magic!r}")
    if version not in (WIRE_VERSION, WIRE_VERSION_QUANT):
        raise KVTransferError(
            f"wire version {version} not in supported "
            f"{(WIRE_VERSION, WIRE_VERSION_QUANT)}"
        )
    off = _HDR.size
    if len(wire) < off + hlen:
        raise KVTransferError("truncated header")
    try:
        header = json.loads(wire[off:off + hlen])
    except ValueError as e:
        raise KVTransferError(f"undecodable header: {e}") from e
    off += hlen
    if version == WIRE_VERSION and "quantization" in header:
        raise KVTransferError("v1 payload carries quantization fields")
    if version == WIRE_VERSION_QUANT and "quantization" not in header:
        raise KVTransferError("v2 payload missing quantization fields")
    quant = version == WIRE_VERSION_QUANT
    try:
        layout = KVLayout(
            n_layer=int(header["n_layer"]),
            block_size=int(header["block_size"]),
            n_kv_head=int(header["n_kv_head"]),
            head_dim=int(header["head_dim"]),
            dtype=str(header["dtype"]),
            quantization=str(header["quantization"]) if quant else None,
            scale_dtype=(str(header.get("scale_dtype", "float32"))
                         if quant else "float32"),
        )
        num_blocks = int(header["num_blocks"])
        prefix_tokens = int(header["prefix_tokens"])
    except (KeyError, ValueError) as e:
        raise KVTransferError(f"malformed header: {e}") from e
    if expect is not None:
        _check_layout_match(layout, expect)
    block_bytes, scale_bytes = layout.block_bytes, layout.scale_bytes
    rec_size = layout.record_bytes
    if len(wire) != off + num_blocks * rec_size:
        raise KVTransferError(
            f"payload size {len(wire)} != expected "
            f"{off + num_blocks * rec_size} for {num_blocks} blocks"
        )
    dtype = storage_dtype(layout.dtype)
    shape = (layout.n_layer, layout.block_size, layout.n_kv_head,
             layout.head_dim)
    records = []
    for i in range(num_blocks):
        chain = wire[off:off + _DIGEST]
        content = wire[off + _DIGEST:off + 2 * _DIGEST]
        off += 2 * _DIGEST
        payload = wire[off:off + layout.record_payload_bytes]
        off += layout.record_payload_bytes
        if hashlib.blake2b(payload, digest_size=_DIGEST).digest() != content:
            raise KVTransferError(f"content digest mismatch on block {i}")
        if not quant:
            k = np.frombuffer(payload[:block_bytes], dtype).reshape(shape)
            v = np.frombuffer(payload[block_bytes:], dtype).reshape(shape)
        else:
            sdtype = storage_dtype(layout.scale_dtype)
            side = block_bytes + scale_bytes

            def _side(buf):
                return QuantizedKV(
                    np.frombuffer(buf[:block_bytes], dtype).reshape(shape),
                    np.frombuffer(buf[block_bytes:], sdtype)
                    .reshape(shape[:-1]))

            k, v = _side(payload[:side]), _side(payload[side:])
        records.append((chain, k, v))
    return layout, prefix_tokens, records
