"""Dataset file helpers (paddle_tpu/data/datasets/common.py): `md5file`,
`download` and `convert`.

`download` never fetches: the port has no network path. It returns the
file cached under `data_home()/module_name` when its md5 matches and
raises otherwise, naming the path to put the file at, as the JAX
package's `download` ends on a host with no egress. `convert` writes
recordio shards, which wait for the port's recordio (ROADMAP.md, queue A,
A12).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from . import data_home

__all__ = ["md5file", "download", "convert"]


def md5file(fname: str) -> str:
    """The md5 of a file, read in 64 KiB pieces."""
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: str, save_name: Optional[str] = None) -> str:
    """The cached, checksum-verified file for `url`; raises RuntimeError
    where it is missing or its md5 differs."""
    filename = os.path.join(data_home(), module_name,
                            save_name if save_name else url.split("/")[-1])
    if os.path.exists(filename) and md5file(filename) == md5sum:
        return filename
    raise RuntimeError(
        f"cannot download {url}: the PyTorch port fetches nothing; put the file at "
        f"{filename} (md5 {md5sum})")


def convert(output_path, reader, line_count, name_prefix):
    raise NotImplementedError(
        "datasets.common.convert writes recordio shards, which are not ported yet "
        "(ROADMAP.md, queue A, A12 recordio)")
