#!/usr/bin/env python3
"""The host rates a commit and a recovery of ``repro_torch.store`` are
made of, on the machine that holds the card, as inputs to a prediction.

    python3 tools/store_rates.py

On one GiB of seeded bytes: sha256 (``hashlib``) and crc32 (``zlib``)
throughput; 4 GiB written to a file under this checkout's git-ignored
``build/`` (seconds to write, then seconds to fsync) and read back from
the page cache; device-to-host copies of the card's memory through a
64 MiB pinned buffer, the store's staging size, and one pageable 1 GiB
copy; the time to allocate 1 GiB of pinned memory.  Also the filesystem
(from /proc/mounts) and free bytes of ``build/``, the host's memory and
core count.  Prints the card's name and power limit, then one JSON
object.  Needs a CUDA card; the file is removed at the end.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

GIB = 1 << 30
CHUNK = 1 << 26


def mount_of(path: str) -> dict:
    best = ("", "?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fs = line.split()[:3]
            if ((path + "/").startswith(mnt.rstrip("/") + "/")
                    and len(mnt) >= len(best[0])):
                best = (mnt, fs, dev)
    return {"mount": best[0], "type": best[1], "device": best[2]}


def main() -> int:
    if not torch.cuda.is_available():
        print("store_rates: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    root = pathlib.Path(__file__).resolve().parent.parent / "build"
    root.mkdir(exist_ok=True)
    st = os.statvfs(root)
    out = {"filesystem": mount_of(str(root)),
           "free_bytes": st.f_bavail * st.f_frsize,
           "cpus": os.cpu_count(),
           "mem_total_kb": int(open("/proc/meminfo").readline().split()[1])}

    buf = np.random.default_rng(0).integers(0, 255, GIB, dtype=np.uint8)
    mv = memoryview(buf)
    t = time.monotonic()
    hashlib.sha256(mv).hexdigest()
    out["sha256_gb_s"] = GIB / 1e9 / (time.monotonic() - t)
    t = time.monotonic()
    zlib.crc32(mv)
    out["crc32_gb_s"] = GIB / 1e9 / (time.monotonic() - t)

    d = tempfile.mkdtemp(prefix="store_rates_", dir=root)
    try:
        path = os.path.join(d, "f")
        t = time.monotonic()
        with open(path, "wb") as f:
            for _ in range(4):
                f.write(mv)
            f.flush()
            t1 = time.monotonic()
            os.fsync(f.fileno())
        out["write_4gib_s"] = t1 - t
        out["fsync_4gib_s"] = time.monotonic() - t1
        t = time.monotonic()
        with open(path, "rb") as f:
            while f.readinto(mv):
                pass
        out["reread_4gib_s"] = time.monotonic() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)

    x = torch.empty(GIB, dtype=torch.uint8, device="cuda")
    pin = torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)
    torch.cuda.synchronize()
    t = time.monotonic()
    for off in range(0, GIB, CHUNK):
        pin.copy_(x[off:off + CHUNK])
    torch.cuda.synchronize()
    out["d2h_pinned_chunks_gb_s"] = GIB / 1e9 / (time.monotonic() - t)
    t = time.monotonic()
    x.cpu()
    out["d2h_pageable_1gib_s"] = time.monotonic() - t
    t = time.monotonic()
    torch.empty(GIB, dtype=torch.uint8, pin_memory=True)
    out["pin_alloc_1gib_s"] = time.monotonic() - t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
