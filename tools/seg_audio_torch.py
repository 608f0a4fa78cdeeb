#!/usr/bin/env python
"""Segment wav files into fixed-duration chunks: the twin of
tools/seg_audio.py on the port's wav I/O (pix2pixhdaudiosr_torch.data),
with no JAX.

Parity: reference data/seg_audio.sh (`ffmpeg -f segment -segment_time
1.2` over every wav in a directory, deleting the originals), non-destructive
by default (`--delete` opts in to the reference's rm). Each source `X.wav`
becomes `X000.wav`, `X001.wav`, ..., the short tail kept, and a file no
longer than one segment becomes `X000.wav`; a source whose segment names
exist already is refused, as the JAX tool refuses it.

Unlike the JAX tool, an input that is one of this tool's own outputs is
skipped: a `<base>NNN.wav` beside its `<base>.wav`, or one of a run
`<base>000.wav`, `<base>001.wav`, ... of at least two files whose every
file but the last is exactly one segment long (what a --delete run
leaves). So a re-run without --delete writes nothing; the JAX tool copies
each segment again as `<segment>000.wav`. A lone `<base>000.wav` whose
source is gone cannot be told from a source and is segmented.

Usage: python tools/seg_audio_torch.py /path/to/wavs [--seconds 1.2] [--delete]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pix2pixhdaudiosr_torch.data.wavio import read_wav, wav_info, write_wav

_SEGMENT = re.compile(r"^(.*)(\d{3})\.wav$", re.IGNORECASE)


def own_outputs(paths, seconds: float) -> set:
    """The paths among `paths` (the wavs of one directory) that are
    segments this tool wrote at `seconds` (see the module docstring),
    decided once for each <base>: a run's headers are read once."""
    listed = set(paths)
    by_base = {}
    for path in paths:
        folder, name = os.path.split(path)
        m = _SEGMENT.match(name)
        if m is not None:
            by_base.setdefault(os.path.join(folder, m.group(1)), []).append(
                (int(m.group(2)), path))
    own = set()
    for base, members in by_base.items():
        if os.path.exists(base + ".wav"):
            own.update(path for _, path in members)
            continue
        run = []
        while f"{base}{len(run):03d}.wav" in listed:
            run.append(f"{base}{len(run):03d}.wav")
        if len(run) < 2:
            continue
        infos = [wav_info(p) for p in run]
        seg = int(round(seconds * infos[0].sample_rate))
        if (all(i.num_frames == seg for i in infos[:-1])
                and 0 < infos[-1].num_frames <= seg):
            own.update(path for n, path in members if n < len(run))
    return own


def segment_file(path: str, seconds: float, delete: bool) -> int:
    audio, rate = read_wav(path)
    audio = np.asarray(audio, np.float32)   # [channels, frames]
    if audio.ndim == 1:
        audio = audio[None]
    seg = int(round(seconds * rate))
    if seg <= 0:
        return 0
    base = os.path.splitext(path)[0]
    # ffmpeg's segmenter emits one (short) segment for a file no longer
    # than segment_time, and keeps the short tail of a longer one
    offsets = range(0, max(audio.shape[1], 1), seg)
    if not delete:
        # without --delete no pre-existing file is overwritten (a partial
        # per-segment skip would leave a misaligned corpus: refuse the file)
        clashes = [f"{base}{i:03d}.wav" for i in range(len(offsets))
                   if os.path.exists(f"{base}{i:03d}.wav")]
        if clashes:
            print(f"skip {path}: refusing to overwrite existing "
                  f"{clashes[0]}" + (f" (+{len(clashes) - 1} more)"
                                     if len(clashes) > 1 else ""),
                  file=sys.stderr)
            return 0
    for n, off in enumerate(offsets):
        write_wav(f"{base}{n:03d}.wav", audio[:, off: off + seg], rate)
    if delete:
        os.remove(path)
    return len(offsets)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--delete", action="store_true",
                    help="remove each source wav after segmenting "
                         "(the reference's behavior)")
    args = ap.parse_args(argv)
    paths = [os.path.join(args.dir, name)
             for name in sorted(os.listdir(args.dir))
             if name.lower().endswith(".wav")]
    # decide on the directory as found, before this run writes into it
    own = own_outputs(paths, args.seconds)
    sources = [p for p in paths if p not in own]
    for p in sorted(own):
        print(f"skip {p}: a segment of this tool's", file=sys.stderr)
    total = sum(segment_file(p, args.seconds, args.delete) for p in sources)
    print(f"wrote {total} segments")
    if total and not args.delete:
        print("note: originals kept (no --delete) — segments were written "
              "NEXT TO them; a re-run skips them, but a corpus built from "
              "this directory sees the same audio twice: point training at "
              "the segments only, or re-run with --delete for the "
              "reference's behavior", file=sys.stderr)
    return total


if __name__ == "__main__":
    main()
