"""Write tests/fixtures/quality_2d.npz: the files of the quality gates' 2D
datasets, decoded as the readers decode them.

    python tests/make_quality_fixture.py

The JAX package's ``data.cvppp.synthesize`` and ``data.bbbc.synthesize``
draw their leaves and nuclei with ``cv2.ellipse`` and write PNG and TIFF
files; this script runs them at the quality gates' arguments
(``tests/test_quality_gate.py``, ``tests/test_quality_gate_bbbc3d.py``)
into a temporary folder and keeps what ``cv2.imread`` gives back, so that
the gates run where cv2 is missing. It needs cv2 and imports the JAX
package (not JAX itself). Keys:

* ``cvppp_names`` (8,): the ``train/plantXXX`` names, sorted;
  ``cvppp_bgr`` (8, 130, 130, 3) uint8, each ``_rgb.png`` as
  ``cv2.IMREAD_COLOR`` decodes it (BGR); ``cvppp_label`` (8, 130, 130)
  uint8, each ``_label.png`` (``cv2.IMREAD_UNCHANGED``);
  ``cvppp_valid_names``: the lines of ``valid_set/local_20_1.txt``;
* ``bbbc_names`` (10,): the ``images/IXM_XXX`` names, sorted;
  ``bbbc_image`` (10, 200, 200) uint16, each ``.tif``; ``bbbc_label``
  (10, 200, 200) uint16, each ``masks_instance`` PNG (both
  ``cv2.IMREAD_UNCHANGED``); ``bbbc_training``, ``bbbc_validation``,
  ``bbbc_test``: the names listed in ``metadata/<split>.txt``.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "quality_2d.npz")
# the JAX gates' synthesize arguments
CVPPP_ARGS = dict(n_train=8, n_valid=2, h=130, w=130, seed=1234)
BBBC_ARGS = dict(n_train=8, n_valid=2, n_test=0, h=200, w=200, seed=4321)


def _lines(path: str) -> list[str]:
    with open(path) as f:
        return [x.strip() for x in f if x.strip()]


def read_cvppp(folder: str) -> dict:
    """The decoded files of a CVPPP-layout folder's training split."""
    import cv2

    d = os.path.join(folder, "train")
    names = sorted({f[:8] for f in os.listdir(d) if "rgb" in f})
    return {"cvppp_names": np.array(names),
            "cvppp_bgr": np.stack([cv2.imread(os.path.join(d, n + "_rgb.png"),
                                              cv2.IMREAD_COLOR) for n in names]),
            "cvppp_label": np.stack([cv2.imread(os.path.join(d, n + "_label.png"),
                                                cv2.IMREAD_UNCHANGED) for n in names]),
            "cvppp_valid_names": np.array(
                _lines(os.path.join(folder, "valid_set", "local_20_1.txt")))}


def read_bbbc(folder: str) -> dict:
    """The decoded files of a BBBC039-layout folder."""
    import cv2

    names = sorted(f[:-4] for f in os.listdir(os.path.join(folder, "images")))
    out = {"bbbc_names": np.array(names),
           "bbbc_image": np.stack([cv2.imread(os.path.join(folder, "images", n + ".tif"),
                                              cv2.IMREAD_UNCHANGED) for n in names]),
           "bbbc_label": np.stack([cv2.imread(os.path.join(folder, "masks_instance",
                                                           n + ".png"),
                                              cv2.IMREAD_UNCHANGED) for n in names])}
    for split in ("training", "validation", "test"):
        out[f"bbbc_{split}"] = np.array(
            [x[:-4] for x in _lines(os.path.join(folder, "metadata", split + ".txt"))],
            dtype=str)
    return out


def synthesize_folders(root: str) -> tuple[str, str]:
    """The JAX package's two synthetic datasets at the gates' arguments,
    written under ``root``: (CVPPP folder, BBBC folder)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from pixel_embedded_affinity_tpu.data import bbbc, cvppp

    cv_dir, bb_dir = os.path.join(root, "cvppp"), os.path.join(root, "bbbc")
    cvppp.synthesize(cv_dir, **CVPPP_ARGS)
    bbbc.synthesize(bb_dir, **BBBC_ARGS)
    return cv_dir, bb_dir


def decoded_files(root: str) -> dict:
    cv_dir, bb_dir = synthesize_folders(root)
    return {**read_cvppp(cv_dir), **read_bbbc(bb_dir)}


def main() -> int:
    with tempfile.TemporaryDirectory() as root:
        arrays = decoded_files(root)
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    for k, v in arrays.items():
        print(f"{k}: {v.dtype} {v.shape}")
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
