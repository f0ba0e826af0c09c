"""Media-directory traversal with the reference's exact filter semantics.

Mirrors ``embed_all_images_in_dir``'s WalkDir stage
(the upstream server's ``server/src/clip.rs:51-69``): follow symlinks, regular
files only, case-insensitive extension whitelist
{jpg, jpeg, png, gif, bmp, webp, tiff}, log-and-skip traversal errors, and
(optionally) shuffle the full list before chunking (clip.rs:69 — shuffling
spreads expensive directories across chunks for steadier progress).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Iterator, List, Optional

log = logging.getLogger(__name__)

# clip.rs:63-64
IMAGE_EXTENSIONS = frozenset({"jpg", "jpeg", "png", "gif", "bmp", "webp", "tiff"})


def is_image_path(path: str) -> bool:
    ext = os.path.splitext(path)[1]
    return bool(ext) and ext[1:].lower() in IMAGE_EXTENSIONS


def iter_images(media_dir: str, follow_symlinks: bool = True) -> Iterator[str]:
    def on_error(err: OSError) -> None:
        # permission errors etc are encountered here (clip.rs:54-57)
        log.error("Image walk error: %s", err)

    # Symlink-cycle guard: the reference's walkdir reports symlink loops as
    # errors and stops descending; os.walk(followlinks=True) would re-emit
    # every file once per nesting level until ELOOP. Track each visited
    # directory by the (st_dev, st_ino) of its resolved target and prune
    # already-seen dirs — this kills cycles AND diamond-link duplicates.
    seen_dirs: set = set()

    def _dir_key(path: str):
        st = os.stat(path)  # follows symlinks
        return (st.st_dev, st.st_ino)

    try:
        seen_dirs.add(_dir_key(media_dir))
    except OSError as err:
        log.error("Image walk error: %s", err)

    for root, dirs, files in os.walk(media_dir, onerror=on_error, followlinks=follow_symlinks):
        if follow_symlinks:
            kept = []
            for d in dirs:
                sub = os.path.join(root, d)
                try:
                    key = _dir_key(sub)
                except OSError as err:
                    log.error("Image walk error: %s", err)
                    continue
                if key in seen_dirs:
                    log.error("Image walk error: directory loop at %s (already visited)", sub)
                    continue
                seen_dirs.add(key)
                kept.append(d)
            dirs[:] = kept  # in-place: os.walk descends only into survivors
        for name in files:
            path = os.path.join(root, name)
            if not is_image_path(path):
                continue
            try:
                if not os.path.isfile(path):  # filters broken symlinks
                    continue
            except OSError as err:
                log.error("Image stat error for %s: %s", path, err)
                continue
            yield path


def find_images(
    media_dir: str,
    shuffle: bool = True,
    seed: Optional[int] = None,
    follow_symlinks: bool = True,
) -> List[str]:
    paths = list(iter_images(media_dir, follow_symlinks))
    if shuffle:
        random.Random(seed).shuffle(paths)
    log.info("Found %d images in directory %s.", len(paths), media_dir)
    return paths
