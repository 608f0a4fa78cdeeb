#!/usr/bin/env python
"""VCTK 0.92 corpus preparation on the PyTorch port: a jax-free copy of
tools/fetch_vctk.py (its commands, flags and output), decoding through
pix2pixhdaudiosr_torch.data. It downloads nothing.

The reference trains on VCTK (target, 48 kHz) and HiFi-TTS (pre-training)
discovered by directory walk or csv list. This tool makes the flagship
recipe runnable the moment a corpus is available:

  1. `--download-instructions` prints the canonical source URL + checksum
     (download on a connected host).
  2. `verify` checks an existing archive's sha256.
  3. `prepare` validates the extracted layout (decodes a sample of files
     through the port's FLAC/WAV readers), then writes train.csv /
     test.csv through tools/split_dataset_torch.py semantics.

After `prepare`, the reference's production recipe runs on the port:

  python train_torch.py --name VCTK_G3L2_48ngf --dataroot <out>/train.csv \\
      --netG local --ngf 48 --n_blocks_global 3 --n_blocks_local 2 \\
      --no_instance --label_nc 0 --input_nc 2 --output_nc 2 \\
      --mask --mask_mode mode2 --center --explicit_encoding \\
      --batchSize 64 --lr_sampling_rate 16000

Usage:
  python tools/fetch_vctk_torch.py --download-instructions
  python tools/fetch_vctk_torch.py verify   /path/to/VCTK-Corpus-0.92.zip
  python tools/fetch_vctk_torch.py prepare  /path/to/extracted \\
      --out data/vctk --test 1000
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pix2pixhdaudiosr_torch.data import discover_files, read_wav  # noqa: E402

VCTK_URL = ("https://datashare.ed.ac.uk/bitstream/handle/10283/3443/"
            "VCTK-Corpus-0.92.zip")
VCTK_SHA256 = "f96258be9fdc2cbff6559541aae7ea4f59df3fcaf5cf963aae5ca647357e359c"
# mic1, 48 kHz flac; the reference's recipes use the 48 kHz wavs/flacs
EXPECTED_SUBDIR = "wav48_silence_trimmed"


def instructions() -> None:
    print("VCTK 0.92 (this tool downloads nothing: fetch it on a connected "
          "host):")
    print(f"  curl -LO {VCTK_URL}")
    print(f"  sha256: {VCTK_SHA256}")
    print("  unzip VCTK-Corpus-0.92.zip")
    print(f"  audio: <root>/{EXPECTED_SUBDIR}/p225/p225_001_mic1.flac ...")
    print("Then: python tools/fetch_vctk_torch.py prepare <root> --out "
          "data/vctk")


def verify(path: str) -> int:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    digest = h.hexdigest()
    ok = digest == VCTK_SHA256
    verdict = "OK" if ok else "MISMATCH (expected " + VCTK_SHA256 + ")"
    print(f"{path}: sha256 {digest} {verdict}")
    return 0 if ok else 1


def prepare(dataroot: str, out: str, test: int, seed: int,
            sample: int = 8) -> int:
    root = dataroot
    sub = os.path.join(dataroot, EXPECTED_SUBDIR)
    if os.path.isdir(sub):
        root = sub
    files = discover_files(root)
    if not files:
        print(f"no audio files under {root}", file=sys.stderr)
        return 1
    print(f"{len(files)} audio files under {root}")

    # decode a deterministic sample end-to-end through the readers (catches
    # truncated downloads and unsupported encodings early)
    rng = random.Random(seed)
    for p in rng.sample(files, min(sample, len(files))):
        wav, rate = read_wav(p, frame_offset=0, num_frames=4096)
        assert wav.ndim == 2 and wav.shape[1] > 0, p
        print(f"  decoded {os.path.basename(p)}: {wav.shape[1]} frames @ "
              f"{rate} Hz")

    rng = random.Random(seed)
    rng.shuffle(files)
    test_files, train_files = files[:test], files[test:]
    os.makedirs(out, exist_ok=True)
    for name, items in (("train.csv", train_files), ("test.csv", test_files)):
        path = os.path.join(out, name)
        with open(path, "w") as f:
            f.writelines("%s\n" % os.path.relpath(i, out) for i in items)
        print(f"{path}: {len(items)} files")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--download-instructions", action="store_true")
    sub = p.add_subparsers(dest="cmd")
    v = sub.add_parser("verify")
    v.add_argument("archive")
    pr = sub.add_parser("prepare")
    pr.add_argument("dataroot")
    pr.add_argument("--out", default="data/vctk")
    pr.add_argument("--test", type=int, default=1000)
    pr.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)
    if args.download_instructions:
        instructions()
        return 0
    if args.cmd == "verify":
        return verify(args.archive)
    if args.cmd == "prepare":
        return prepare(args.dataroot, args.out, args.test, args.seed)
    p.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
