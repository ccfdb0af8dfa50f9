"""Write the zstd frames that the port's native decoder is held against
where there is no libzstd binding (the card's machine), and record the
sha256 of the bytes each frame was made from.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/zstd/make_corpus.py

from the root of a checkout with `tensorstore` and `zstandard`
importable.  It replaces the `*.zst` files and `corpus.json` beside this
file.  Between them the frames take every block, literals and table
mode that `singa_tpu_torch.utils.zstd` counts:

- `ts_l<level>_<array>.zst`: the zarr v2 chunk tensorstore writes for
  one array of `tests/test_torch_ocdbt.py`'s `_arrays()` with the zstd
  compressor at that level (libzstd's frames, as orbax writes them).
- `checksummed.zst`: a skippable frame, then two frames that `zstandard`
  writes at level 1 with a content checksum.
- `corpus.json`: per frame file, the size and sha256 of the bytes it
  was made from, and its source.
"""

import hashlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import zstandard  # noqa: E402

from test_torch_ocdbt import _arrays, _ts_zarr  # noqa: E402

# (level, array): a small set that still takes every mode
TS_FRAMES = ((19, "tiny"), (19, "ramp"), (3, "rle_literals"), (9, "ints"),
             (-5, "ints"), (1, "zeros"), (3, "rows"))


def record(out: dict, name: str, frame: bytes, data: bytes, source: str):
    with open(os.path.join(HERE, name), "wb") as f:
        f.write(frame)
    out[name] = {"size": len(data),
                 "sha256": hashlib.sha256(data).hexdigest(),
                 "source": source}


def main() -> None:
    for f in os.listdir(HERE):
        if f.endswith(".zst"):
            os.remove(os.path.join(HERE, f))
    arrays = _arrays()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for level, name in TS_FRAMES:
            arr = arrays[name]
            path = os.path.join(tmp, f"{name}_{level}")
            _ts_zarr(path, arr, compressor={"id": "zstd", "level": level})
            with open(os.path.join(path, "0" if arr.ndim == 1 else "0.0"),
                      "rb") as f:
                frame = f.read()
            record(out, f"ts_l{level}_{name}.zst", frame, arr.tobytes(),
                   f"tensorstore zarr v2 chunk, zstd level {level}")
    data = arrays["rand_f32"].tobytes()[:20000] + bytes(10000)
    one = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(
        data)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"12345"
    record(out, "checksummed.zst", skippable + one + one, data + data,
           "zstandard level 1 with content checksums, after a skippable "
           "frame")
    with open(os.path.join(HERE, "corpus.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
