"""Fetch Conceptual-Captions images by URL into an on-disk image folder
(port of ``tools/prepare_cc_images.py``).

Parity with the reference's `src/tools/prepare_conceptual_caption_images.py`
(:18-65): a thread-pooled URL fetcher mapped over a dataset's ``image_url``
column, saving each decoded image under ``{image_id}.jpg``. Differences from
the reference script (hard-coded cluster paths, images kept in-memory in the
mapped dataset): this is a reusable function over any id+url table, failures
are counted and reported instead of silently leaving ``None`` rows, and the
fetcher is injectable so the logic is testable offline. The JPEGs are
written by PIL, imported when the function runs (the port reads JPEGs
itself but does not encode them); this offline step is not run on the card.
"""

from __future__ import annotations

import argparse
import io
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional, Tuple

logger = logging.getLogger(__name__)


def _default_fetch(url: str, timeout: float = 10.0, retries: int = 0):
    """GET one image URL -> PIL image, None on any failure (reference
    ``fetch_single_image``, :18-29)."""
    import requests
    from PIL import Image

    for _ in range(retries + 1):
        try:
            response = requests.get(url, stream=True, timeout=timeout)
            if response:
                return Image.open(response.raw)
        except Exception:
            pass
    return None


def fetch_images(
    rows: Iterable[Tuple[str, str]],
    images_dir: str,
    num_threads: int = 16,
    timeout: float = 10.0,
    retries: int = 0,
    fetch_fn: Optional[Callable] = None,
    skip_existing: bool = True,
) -> dict:
    """Fetch ``(image_id, image_url)`` rows into ``images_dir/{id}.jpg``.

    Returns ``{"saved": [...ids], "failed": [...ids], "skipped": n}``.
    """
    from PIL import Image

    fetch = fetch_fn or (
        lambda url: _default_fetch(url, timeout=timeout, retries=retries))
    os.makedirs(images_dir, exist_ok=True)

    pending = []
    skipped = 0
    for image_id, url in rows:
        path = os.path.join(images_dir, f"{image_id}.jpg")
        if skip_existing and os.path.exists(path):
            skipped += 1
            continue
        pending.append((image_id, url, path))

    def work(item):
        image_id, url, path = item
        img = fetch(url)
        if img is None:
            return image_id, None
        try:
            if not isinstance(img, Image.Image):
                img = Image.open(io.BytesIO(img))
            img.convert("RGB").save(path)
        except Exception:
            return image_id, None
        return image_id, path

    saved, failed = [], []
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        for image_id, path in pool.map(work, pending):
            (saved if path else failed).append(image_id)
    logger.info("fetched %d images (%d failed, %d already present)",
                len(saved), len(failed), skipped)
    return {"saved": saved, "failed": failed, "skipped": skipped}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", help="save_to_disk dataset directory with "
                                    "image_id/image_url columns")
    ap.add_argument("images_dir")
    ap.add_argument("--id-column", default="image_id")
    ap.add_argument("--url-column", default="image_url")
    ap.add_argument("--num-threads", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--retries", type=int, default=0)
    args = ap.parse_args(argv)

    from ..data.arrow_io import load_from_disk

    if args.dataset.endswith(".parquet"):
        raise NotImplementedError(f"{args.dataset}: parquet files are not read by the port; "
                                  "give a save_to_disk directory")
    ds = load_from_disk(args.dataset)
    out = fetch_images(
        zip(ds[args.id_column], ds[args.url_column]),
        args.images_dir,
        num_threads=args.num_threads,
        timeout=args.timeout,
        retries=args.retries,
    )
    print(f"saved {len(out['saved'])}, failed {len(out['failed'])}, "
          f"skipped {out['skipped']}")


if __name__ == "__main__":
    main()
