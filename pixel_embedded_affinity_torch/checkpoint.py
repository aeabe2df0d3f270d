"""Read and write the JAX package's msgpack checkpoints without JAX or Flax.

The JAX package writes ``flax.serialization.msgpack_serialize`` of its train
state: ``msgpack.packb(tree, strict_types=True)`` of nested maps with str
keys (sorted, as JAX's pytree flattening orders them), whose array leaves
are msgpack ext type 1, each holding the msgpack triple ``(shape, dtype
name, C-order bytes)``; numpy scalars are ext type 3 with the same
payload. Parameters are float32 (Flax's ``param_dtype``), so no bfloat16
leaf needs decoding. Coding this here lets one checkpoint serve and
resume in both packages.
"""

from __future__ import annotations

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def load_jax_checkpoint(fname: str) -> dict:
    """Decode a Flax msgpack checkpoint into nested dicts of numpy arrays."""
    import msgpack

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        return msgpack.ExtType(code, data)

    with open(fname, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def sorted_tree(tree):
    """A nested dict with every map's keys in sorted order, the order in
    which Flax's serialisation writes them."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def write_jax_checkpoint(fname: str, tree: dict):
    """Write ``tree`` (nested dicts of numpy leaves) as the JAX package's
    ``save_checkpoint`` does, the bytes of Flax's ``msgpack_serialize``."""
    import msgpack

    def ext_pack(x):
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.asarray(x)
            payload = msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True)
            return msgpack.ExtType(_EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR,
                                   payload)
        return x

    with open(fname, "wb") as f:
        f.write(msgpack.packb(sorted_tree(tree), default=ext_pack, strict_types=True))
