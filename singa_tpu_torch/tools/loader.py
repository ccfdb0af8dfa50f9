"""Data loader tool — the reference's `loader` binary
(tools/data_loader/data_loader.cc).  The port's own copy of
`singa_tpu/tools/loader.py`, over the port's `data/records.py`,
`data/shard.py` and `data/lmdb_reader.py`: the same modes write the
same bytes.  OpenCV is imported only by the imagefolder source.

Modes (same surface):
  create: convert MNIST idx files, a CIFAR-10 binary folder, or an
          ImageNet-style image folder + list file into a Shard of
          Record protos (data_loader.cc:112-145; ImageNetSource
          data_source.h:63-148: cv2 resize, CHW uint8)
  split:  re-partition a shard into N sub-shards (Split/SplitN,
          data_loader.cc:43-94)
  partition: per-worker dataset placement for multi-host training —
          script/load_data.py's partition(): group-sliced, replicated
          or split inside each group, one proc{i}/ shard per worker
  mean:   compute the per-pixel float mean of a shard and write it as a
          single Record (the reference's mean.binaryproto role)
  convert-lmdb: walk a caffe LMDB environment of Datum values
          (layer.cc:237-328's data source) and rewrite it as a Shard
          of Record protos, so the native batch decoder applies

Usage:
  python -m singa_tpu_torch.tools.loader create mnist  <images.idx> <labels.idx> <out_folder>
  python -m singa_tpu_torch.tools.loader create cifar10 <data_batch.bin...> <out_folder>
  python -m singa_tpu_torch.tools.loader create imagefolder <img_dir> <list_file> <out_folder> [size]
  python -m singa_tpu_torch.tools.loader split <in_folder> <out_prefix> <n>
  python -m singa_tpu_torch.tools.loader partition <in_folder> <out_root> <nworkers> [group_size] [--replicate] [--shuffle[=seed]]
  python -m singa_tpu_torch.tools.loader mean <shard_folder> <out_file>
  python -m singa_tpu_torch.tools.loader convert-lmdb <lmdb_env> <out_folder>
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Iterator, List, Tuple

import numpy as np

from ..data.records import Record, SingleLabelImageRecord
from ..data.shard import Shard


def read_mnist_idx(images_path: str, labels_path: str
                   ) -> Iterator[Tuple[np.ndarray, int]]:
    """Parse the MNIST idx format (big-endian headers)."""
    with open(labels_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{labels_path}: bad idx label magic {magic}")
        labels = np.frombuffer(f.read(n), np.uint8)
    with open(images_path, "rb") as f:
        magic, n2, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{images_path}: bad idx image magic {magic}")
        if n2 != n:
            raise ValueError(f"image/label count mismatch: {n2} vs {n}")
        for i in range(n):
            img = np.frombuffer(f.read(rows * cols), np.uint8)
            yield img.reshape(rows, cols), int(labels[i])


def read_cifar10_bins(paths: List[str]) -> Iterator[Tuple[np.ndarray, int]]:
    """CIFAR-10 binary batches: rows of [label u8][3072 pixel u8]."""
    for path in paths:
        with open(path, "rb") as f:
            while True:
                row = f.read(3073)
                if len(row) < 3073:
                    break
                yield (np.frombuffer(row[1:], np.uint8).reshape(3, 32, 32),
                       row[0])


def read_image_folder(img_dir: str, list_path: str, size: int = 256
                      ) -> Iterator[Tuple[np.ndarray, int]]:
    """ImageNet-style source (data_source.h:63-148): a list file of
    `relative_path label` lines; each image is decoded + resized to
    (size, size) with OpenCV and stored CHW uint8 (BGR channel order,
    matching what the reference's cv-based loader wrote)."""
    import cv2
    with open(list_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            name = parts[0]
            label = int(parts[1]) if len(parts) > 1 else 0
            img = cv2.imread(os.path.join(img_dir, name))
            if img is None:
                print(f"warning: unreadable image {name!r}, skipped",
                      file=sys.stderr)
                continue
            img = cv2.resize(img, (size, size))
            yield img.transpose(2, 0, 1), label


def compute_mean(shard_folder: str, out_path: str) -> np.ndarray:
    """Per-pixel float mean over every record of a shard, written as one
    Record with `data` floats (the mean.binaryproto role; consumed as
    the `mean` entry of the input batch for kRGBImage)."""
    total = None
    count = 0
    with Shard(shard_folder, Shard.KREAD) as src:
        for _, val in src:
            rec = Record.decode(val).image
            arr = rec.pixels_array().astype(np.float64)
            total = arr if total is None else total + arr
            count += 1
    if not count:
        raise ValueError(f"{shard_folder}: empty shard")
    mean = (total / count).astype(np.float32)
    out = Record(image=SingleLabelImageRecord(
        shape=list(mean.shape), data=[float(x) for x in mean.ravel()]))
    with open(out_path, "wb") as f:
        f.write(out.encode())
    return mean


def create_shard(source: Iterator[Tuple[np.ndarray, int]], out_folder: str,
                 append: bool = True) -> int:
    """Write (image, label) pairs as Record tuples. Appending is
    restartable: duplicate keys are skipped (data_loader.cc:122-143)."""
    os.makedirs(out_folder, exist_ok=True)
    mode = Shard.KAPPEND if append else Shard.KCREATE
    n = 0
    with Shard(out_folder, mode) as sh:
        for i, (img, label) in enumerate(source):
            rec = Record(image=SingleLabelImageRecord(
                shape=list(img.shape), label=label, pixel=img.tobytes()))
            if sh.insert(f"{i:08d}", rec.encode()):
                n += 1
    return n


def convert_lmdb(lmdb_env: str, out_folder: str) -> int:
    """caffe LMDB → Shard: walk the env in key order, convert each
    Datum to a Record (same keys), and insert into a fresh shard."""
    from ..data.lmdb_reader import iter_lmdb
    from ..data.records import Datum, record_from_datum

    os.makedirs(out_folder, exist_ok=True)
    n = 0
    with Shard(out_folder, Shard.KCREATE) as sh:
        for key, raw in iter_lmdb(lmdb_env):
            rec = record_from_datum(Datum.decode(raw))
            if sh.insert(key, rec.encode()):
                n += 1
    return n


def split_shard(in_folder: str, out_prefix: str, n: int) -> List[int]:
    """Round-robin split into n sub-shards (SplitN semantics)."""
    outs = []
    counts = []
    for i in range(n):
        folder = f"{out_prefix}{i}"
        os.makedirs(folder, exist_ok=True)
        outs.append(Shard(folder, Shard.KCREATE))
        counts.append(0)
    with Shard(in_folder, Shard.KREAD) as src:
        for i, (key, val) in enumerate(src):
            outs[i % n].insert(key, val)
            counts[i % n] += 1
    for sh in outs:
        sh.close()
    return counts


def partition_shard(in_folder: str, out_root: str, nworkers: int,
                    group_size: int = 1, replicate: bool = False,
                    shuffle_seed: int | None = None) -> List[int]:
    """Per-worker dataset placement — script/load_data.py's partition()
    as a shard operation (the reference slices a record-id list per
    worker group, then either replicates the slice inside the group or
    splits it per worker, and scps each list to its host).

    Writes `out_root/proc{i}/` for i in [0, nworkers): worker i (process
    i in the -procsID/-hostfile launch) gets group g = i // group_size's
    contiguous slice of the source records — the whole slice when
    `replicate` (every group member sees the group's data; intra-group
    parallelism splits the batch, not the dataset), else its contiguous
    sub-slice.  Placement on the actual hosts is one rsync of proc{i}/
    per host (the ssh/scp loop has no meaning in this zero-egress
    image).  Returns per-worker record counts."""
    if nworkers <= 0 or group_size <= 0 or nworkers % group_size:
        raise ValueError(f"nworkers {nworkers} must be a positive "
                         f"multiple of group_size {group_size}")
    with Shard(in_folder, Shard.KREAD) as src:
        records = list(src)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(records)
    ngroups = nworkers // group_size
    per_group = len(records) // ngroups
    counts = []
    for i in range(nworkers):
        g, k = divmod(i, group_size)
        # the last group absorbs the remainder (the reference's integer
        # division silently DROPPED the tail; records are too expensive
        # to lose on purpose)
        g_end = (g + 1) * per_group if g < ngroups - 1 else len(records)
        grp = records[g * per_group:g_end]
        if replicate:
            mine = grp
        else:
            per_w = len(grp) // group_size
            w_end = ((k + 1) * per_w if k < group_size - 1 else len(grp))
            mine = grp[k * per_w:w_end]
        folder = os.path.join(out_root, f"proc{i}")
        os.makedirs(folder, exist_ok=True)
        with Shard(folder, Shard.KCREATE) as out:
            for key, val in mine:
                out.insert(key, val)
        counts.append(len(mine))
    return counts


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    cmd = argv[0]
    if cmd == "create" and len(argv) >= 2 and argv[1] == "mnist":
        images, labels, out = argv[2:5]
        n = create_shard(read_mnist_idx(images, labels), out)
        print(f"wrote {n} records to {out}")
    elif cmd == "create" and len(argv) >= 2 and argv[1] == "cifar10":
        *bins, out = argv[2:]
        n = create_shard(read_cifar10_bins(bins), out)
        print(f"wrote {n} records to {out}")
    elif cmd == "create" and len(argv) >= 2 and argv[1] == "imagefolder":
        img_dir, list_file, out = argv[2:5]
        size = int(argv[5]) if len(argv) > 5 else 256
        n = create_shard(read_image_folder(img_dir, list_file, size), out)
        print(f"wrote {n} records to {out}")
    elif cmd == "convert-lmdb":
        env, out = argv[1], argv[2]
        n = convert_lmdb(env, out)
        print(f"converted {n} LMDB records to {out}")
    elif cmd == "split":
        in_folder, out_prefix, n = argv[1], argv[2], int(argv[3])
        counts = split_shard(in_folder, out_prefix, n)
        print(f"split into {counts}")
    elif cmd == "partition":
        flags = [a for a in argv[1:] if a.startswith("--")]
        pos = [a for a in argv[1:] if not a.startswith("--")]
        in_folder, out_root, nworkers = pos[0], pos[1], int(pos[2])
        gsize = int(pos[3]) if len(pos) > 3 else 1
        seed = None
        for f in flags:
            if f.startswith("--shuffle"):
                seed = int(f.split("=")[1]) if "=" in f else 0
        counts = partition_shard(in_folder, out_root, nworkers, gsize,
                                 replicate="--replicate" in flags,
                                 shuffle_seed=seed)
        print(f"partitioned into {counts} (proc0..proc{nworkers - 1} "
              f"under {out_root})")
    elif cmd == "mean":
        shard_folder, out_path = argv[1], argv[2]
        mean = compute_mean(shard_folder, out_path)
        print(f"wrote mean {mean.shape} to {out_path}")
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
