#!/usr/bin/env python
"""Train/test csv splitter: the twin of tools/split_dataset.py on the
port's `data.filelist`, with no JAX (reference test/split.py parity). It
walks a corpus directory, shuffles with `--seed`, and writes the first N
paths to test.csv and the rest to train.csv, relative to the output
directory (the layout data/filelist.py reads).

Usage: python tools/split_dataset_torch.py /path/to/VCTK/wav48 --test 1000 --out .
"""

from __future__ import annotations

import argparse
import os
import random
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pix2pixhdaudiosr_torch.data.filelist import discover_files


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataroot")
    p.add_argument("--test", type=int, default=1000)
    p.add_argument("--out", type=str, default=".")
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)

    files = discover_files(args.dataroot)
    random.Random(args.seed).shuffle(files)
    test, train = files[: args.test], files[args.test:]
    os.makedirs(args.out, exist_ok=True)
    for name, items in (("train.csv", train), ("test.csv", test)):
        path = os.path.join(args.out, name)
        with open(path, "w") as f:
            f.writelines("%s\n" % os.path.relpath(i, args.out) for i in items)
        print(f"{path}: {len(items)} files")


if __name__ == "__main__":
    main()
