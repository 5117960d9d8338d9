# -*- coding: utf-8 -*-
"""Dataset distribution tooling (the port's copy of
``drin_tpu/tools/data_tools.py``, the reference's ``dataset/data_tools.py``):
disguise zip archives as MP4 files for webdrive sharing and verify md5 on
decode.

Container format (data_tools.py:8-24) — these constants ARE the on-disk
format and must match to decode existing archives: the file's first 32 bytes
are swapped with a standard MP4 header, and the displaced 32 original bytes
are stashed at EOF.  Decoding swaps them back and truncates.  A ``md5.json``
beside the archives records pre-encode checksums.

CLI: ``python -m drin_tpu_torch.tools.data_tools [--encode] --dir D
--raw_files a.zip --encoded_files a.mp4 [--skip_checksum]``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from argparse import ArgumentParser

MP4_HEADER = b"\x00\x00\x00 ftypisom\x00\x00\x02\x00isomiso2avc1mp41"
HEADER_LEN = len(MP4_HEADER)
MD5_FILENAME = "md5.json"


def md5(filename: str) -> str:
    h = hashlib.md5()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _swap_head(filename: str, to_mp4: bool) -> None:
    """Swap the archive's leading 32 bytes with the MP4 signature.

    Encoding stashes the displaced bytes at EOF; decoding pulls them back
    from EOF and truncates.  Both directions are exact inverses."""
    with open(filename, "br+") as f:
        if to_mp4:
            displaced = f.read(HEADER_LEN)
            f.seek(0)
            f.write(MP4_HEADER)
            f.seek(0, io.SEEK_END)
            f.write(displaced)
        else:
            f.seek(-HEADER_LEN, io.SEEK_END)
            displaced = f.read(HEADER_LEN)
            f.seek(0)
            f.write(displaced)
            f.seek(-HEADER_LEN, io.SEEK_END)
            f.truncate()


def encode(dir: str, raw_files, encoded_files, skip_checksum: bool = False, log=print):
    """zip archives -> mp4-disguised; returns the checksum manifest."""
    checksums = {}
    for src, dst in zip(raw_files, encoded_files):
        src_path, dst_path = os.path.join(dir, src), os.path.join(dir, dst)
        if not os.path.exists(src_path):
            log(f"skip (missing): {src_path}")
            continue
        if not skip_checksum:
            checksums[src] = md5(src_path)
        os.rename(src_path, dst_path)
        _swap_head(dst_path, to_mp4=True)
        log(f"encoded {src} as {dst}")
    if not skip_checksum:
        with open(os.path.join(dir, MD5_FILENAME), "w") as f:
            json.dump(checksums, f)
    return checksums


def decode(dir: str, raw_files, encoded_files, skip_checksum: bool = False, log=print):
    """mp4-disguised -> zip archives; returns {raw_name: checksum_ok}."""
    manifest = {}
    if not skip_checksum:
        with open(os.path.join(dir, MD5_FILENAME)) as f:
            manifest = json.load(f)
    results = {}
    for src, dst in zip(raw_files, encoded_files):
        src_path, dst_path = os.path.join(dir, src), os.path.join(dir, dst)
        if not os.path.exists(dst_path):
            log(f"skip (missing): {dst_path}")
            continue
        os.rename(dst_path, src_path)
        _swap_head(src_path, to_mp4=False)
        log(f"decoded {dst} back to {src}")
        if skip_checksum:
            results[src] = True
        else:
            results[src] = manifest.get(src) == md5(src_path)
            log(f"checksum {'ok' if results[src] else 'MISMATCH'}: {src}")
    return results


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--dir", default=".")
    p.add_argument("--encode", action="store_true")
    p.add_argument("--skip_checksum", action="store_true")
    p.add_argument("--raw_files", nargs="+", default=[])
    p.add_argument("--encoded_files", nargs="+", default=[])
    args = p.parse_args(argv)
    if args.encode:
        encode(args.dir, args.raw_files, args.encoded_files, args.skip_checksum)
    else:
        decode(args.dir, args.raw_files, args.encoded_files, args.skip_checksum)


if __name__ == "__main__":
    main()
