"""Amazon raw-review fetcher (reference dataset/Amazon/get_raw_data.py:7-41).

Counterpart of ``mamdr_tpu/data/etl/get_raw_data.py``, in the standard
library. The reference downloads 5-core category review files
(``{Category}_5.json.gz``) from the UCSD endpoint; this module keeps that
filename contract and the JAX package's overrides:

  - ``mirror_path`` (or env ``MAMDR_AMAZON_MIRROR``): a local directory
    holding the category files (the reference's name, or without ``_5``),
    copied into place instead of downloaded;
  - ``base_url`` (or env ``MAMDR_AMAZON_BASE_URL``): replaces the URL
    template (any http(s) or ``file://`` URL with a ``{}`` slot for the
    filename);
  - otherwise ``urllib`` downloads from the reference's endpoint.

A file already at the target is left alone unless ``redownload``.

CLI: ``python -m mamdr_tpu_torch.data.etl.get_raw_data --categories "Video
Games" --target raw_data [--mirror DIR] [--base-url URL] [--redownload]``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import urllib.request
from typing import List, Optional

DEFAULT_BASE_URL = "http://deepyeti.ucsd.edu/jianmo/amazon/categoryFilesSmall/{}"
BASE_NAME = "{}_5.json.gz"


def category_name_to_filename(category_name: str) -> str:
    """The reference's file name of a category (get_raw_data.py:10-11)."""
    return BASE_NAME.format(category_name.replace(", ", "_").replace(" ", "_"))


def _resolve_mirror(filename: str, mirror_path: str) -> Optional[str]:
    """The file in a local mirror directory, with or without the ``_5``
    suffix; None when it is not there."""
    for cand in (filename, filename.replace("_5.json.gz", ".json.gz")):
        p = osp.join(mirror_path, cand)
        if osp.exists(p):
            return p
    return None


def download(file_path: str, filename: str, base_url: str) -> bool:
    """Fetch ``base_url.format(filename)`` to ``file_path`` through a
    ``.part`` file renamed into place; raises ``RuntimeError`` (and leaves
    no partial file) when the fetch fails."""
    url = base_url.format(filename)
    print(f"Download: {url}")
    tmp = file_path + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(tmp, file_path)
        return True
    except Exception as e:
        if osp.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"Download file {file_path} failed: {e}") from e


def get_raw_data_path(category: str, target_path: str, redownload: bool = False,
                      base_url: Optional[str] = None,
                      mirror_path: Optional[str] = None) -> str:
    """The category's raw file under ``target_path``, copied from the mirror
    or fetched when it is not there yet (or ``redownload``); returns its
    path. A mirror without the file raises ``FileNotFoundError``."""
    filename = category_name_to_filename(category)
    file_path = osp.join(target_path, filename)
    if osp.exists(file_path) and not redownload:
        print(f"File {filename} already exists in: {file_path}")
        return file_path
    os.makedirs(target_path, exist_ok=True)

    mirror_path = mirror_path or os.environ.get("MAMDR_AMAZON_MIRROR", "")
    if mirror_path:
        src = _resolve_mirror(filename, mirror_path)
        if src is None:
            raise FileNotFoundError(f"{filename} not found in mirror {mirror_path}")
        shutil.copyfile(src, file_path)
        print(f"{filename} copied from mirror to {file_path}")
        return file_path

    base_url = base_url or os.environ.get("MAMDR_AMAZON_BASE_URL", DEFAULT_BASE_URL)
    download(file_path, filename, base_url)
    print(f"{filename} saved at {file_path}")
    return file_path


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Fetch Amazon 5-core category review files")
    parser.add_argument("--categories", nargs="+", required=True)
    parser.add_argument("--target", type=str, required=True)
    parser.add_argument("--mirror", type=str, default=None)
    parser.add_argument("--base-url", type=str, default=None)
    parser.add_argument("--redownload", action="store_true")
    args = parser.parse_args(argv)
    for c in args.categories:
        get_raw_data_path(c, args.target, redownload=args.redownload,
                          base_url=args.base_url, mirror_path=args.mirror)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
