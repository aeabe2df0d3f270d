"""Read the JAX package's msgpack checkpoints without JAX or Flax.

The JAX package writes ``flax.serialization.msgpack_serialize`` of its train
state: nested maps whose array leaves are msgpack ext type 1, each holding
the msgpack triple ``(shape, dtype name, C-order bytes)``; numpy scalars are
ext type 3 with the same payload. Parameters are float32 (Flax's
``param_dtype``), so no bfloat16 leaf needs decoding. Decoding this here
lets one checkpoint serve both packages.
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
