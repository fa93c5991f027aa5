"""Item images and titles for the uncached pipeline (host side, numpy).

Port of ``iisan_tpu/data/images.py`` and of the synthetic token rows of
``scripts/bench_uncached.py``:

- ``normalize_images``: uint8 (N, H, W, 3) -> [-1, 1] in the compute dtype,
  on the device, by the JAX cast chain: the cast to the dtype first, then
  ``* (2/255)`` and ``- 1`` in that dtype, each rounded to it;
- ``LMDBImage`` and ``LmdbImageStore``: the reference's LMDB layout
  (pickled records keyed by item name, plus ``__keys__`` / ``__len__``),
  read through ``lmdb`` when it is installed, else through the port's
  pure-Python LMDB backend (``data/lmdbfile.py``; ``LMDB_BACKEND`` names
  the one in use).  Records are unpickled by ``load_record``, which
  resolves the record classes of the reference, the JAX package and the
  port to the port's ``LMDBImage`` and refuses every other global, so a
  record never imports the JAX package or runs code;
- ``DirImageStore``: a directory of ``<name>.jpg`` files, decoded by the
  port's build of ``csrc/fastimage.cc`` (libjpeg: Pillow's bundled one or
  the system's), or by Pillow where neither is found;
- ``SyntheticImageStore``: a seeded random image per item name;
- ``open_image_source``: the store a path names (both entry points route
  through it);
- ``build_lmdb``: the reference-layout LMDB from a directory of JPEGs;
- ``ParallelImageLoader``: a thread pool that decodes one batch of names
  while the device runs the previous one (prefetch depth 2); a ``None``
  name (the pad item, id 0) is an all-zero image;
- ``synthetic_token_table``: the packed ``[ids | mask]`` title rows.

Resizing (``LmdbImageStore``, and ``DirImageStore`` for what libjpeg does
not decode) and decoding in ``build_lmdb`` use Pillow's, as the JAX
package does: ``Image.resize(..., BILINEAR)`` and ``Image.open(...)
.convert("RGB")``.  Where Pillow is missing, the path that needs it raises
an error naming it.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Sequence

import numpy as np
import torch

from . import fastimage

try:  # the reference's storage backend (native liblmdb), where installed
    import lmdb  # type: ignore
    LMDB_BACKEND = "lmdb"
except ImportError:  # the same on-disk format in pure Python
    from . import lmdbfile as lmdb  # type: ignore

    LMDB_BACKEND = "pure-Python (iisan_tpu_torch.data.lmdbfile)"

log = logging.getLogger("iisan_tpu_torch")


def _pil_image():
    """Pillow's ``Image`` module, or an ImportError naming what needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "Pillow is not installed: the image stores resize with its "
            "bilinear filter and build_lmdb decodes with it, as the JAX "
            "package does") from e
    return Image


def _resize_u8(img_u8: np.ndarray, resize: int) -> np.ndarray:
    """uint8 HWC RGB -> (resize, resize, 3) uint8 by Pillow's bilinear
    filter, as ``iisan_tpu/data/images.py``'s ``_resize_u8``."""
    Image = _pil_image()
    im = Image.fromarray(img_u8).convert("RGB").resize(
        (resize, resize), Image.BILINEAR)
    return np.asarray(im, dtype=np.uint8)


def normalize_images(u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 -> ``u8 * (2/255) - 1`` computed in ``dtype``.  The scalars
    are ``dtype`` tensors, so each operation rounds to ``dtype`` as the JAX
    package's does (a Python scalar would keep fp32 precision in torch)."""
    x = u8.to(dtype)
    scale = torch.tensor(2.0 / 255.0, dtype=dtype, device=x.device)
    one = torch.tensor(1.0, dtype=dtype, device=x.device)
    return x * scale - one


class LMDBImage:
    """The record layout of the reference's ``Dataset/build_lmdb.py``
    (``LMDB_Image``) and of the JAX package's ``LMDBImage``."""

    def __init__(self, image: np.ndarray, id):
        self.channels = image.shape[2]
        self.size = image.shape[:2]
        self.image = image.tobytes()
        self.id = id

    def get_image(self) -> np.ndarray:
        arr = np.frombuffer(self.image, dtype=np.uint8)
        return arr.reshape(*self.size, self.channels)


# (module, name) of the record classes an image LMDB may hold: the
# reference's, pickled by its build script run as ``__main__``, the JAX
# package's and the port's own.
RECORD_CLASSES = frozenset({
    ("__main__", "LMDB_Image"),
    ("iisan_tpu.data.images", "LMDBImage"),
    ("iisan_tpu_torch.data.images", "LMDBImage"),
})


class _RecordUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in RECORD_CLASSES:
            return LMDBImage
        raise pickle.UnpicklingError(
            f"image record refers to {module}.{name}, which is not an image "
            f"record class ({sorted(RECORD_CLASSES)})")


def load_record(raw: bytes):
    """Unpickle an image LMDB value (an image record, or the ``__keys__``
    list and ``__len__`` count) without importing anything: the record
    classes become ``LMDBImage``; any other global raises."""
    return _RecordUnpickler(io.BytesIO(raw)).load()


def is_lmdb_path(path: str) -> bool:
    """True when ``path`` is an LMDB source: a single data file, or the
    directory form lmdb itself writes (``data.mdb`` inside).  A plain
    directory of JPEGs is not an LMDB and routes to DirImageStore."""
    if not path:
        return False
    return os.path.isfile(path) or os.path.isfile(
        os.path.join(path, "data.mdb"))


class LmdbImageStore:
    """Reads the reference LMDB layout (keys = ascii item names, plus
    ``__keys__`` / ``__len__``; the cached variants strip 'v' from names,
    ``strip_v``).  ``get`` returns the record's image resized by Pillow's
    bilinear filter to (resize, resize, 3) uint8."""

    def __init__(self, db_path: str, resize: int = 224, strip_v: bool = False):
        self.env = lmdb.open(db_path, subdir=os.path.isdir(db_path),
                             readonly=True, lock=False, readahead=False,
                             meminit=False)
        self.resize = resize
        self.strip_v = strip_v
        log.info("image LMDB %s through the %s backend", db_path, LMDB_BACKEND)

    def key(self, name: str) -> bytes:
        if self.strip_v:
            name = name.replace("v", "")
        return name.encode("ascii")

    def get(self, name: str) -> np.ndarray:
        with self.env.begin() as txn:
            raw = txn.get(self.key(name))
        if raw is None:
            raise KeyError(f"no image record for {name!r} "
                           f"(key {self.key(name)!r})")
        return _resize_u8(load_record(raw).get_image(), self.resize)


class DirImageStore:
    """A directory of ``<name>.jpg`` files, decoded and resized by the
    port's build of ``csrc/fastimage.cc`` (libjpeg with DCT-domain
    downscaling and a bilinear remainder; the JAX package's native path,
    pixel for pixel; ``fastimage.route()`` names the libjpeg linked).  A
    file libjpeg cannot decode (a PNG named ``.jpg``) takes Pillow's decode
    and bilinear resize, the JAX package's fallback.  Where no libjpeg is
    found (``fastimage.DecoderUnavailable``), every image takes that
    fallback, with a warning naming the missing library, as the JAX
    package's store does without its native library (``native`` is then
    False).
    """

    def __init__(self, root: str, resize: int = 224):
        self.root = root
        self.resize = resize
        try:
            fastimage.library()
            self.native = True
        except fastimage.DecoderUnavailable as e:
            log.warning("no libjpeg for the JPEG decoder (%s): the images of "
                        "%s are decoded and resized by Pillow", str(e).splitlines()[0],
                        root)
            self.native = False

    def get(self, name: str) -> np.ndarray:
        path = os.path.join(self.root, name + ".jpg")
        if self.native:
            with open(path, "rb") as f:
                out, ok = fastimage.decode_resize(f.read(), self.resize)
            if ok:
                return out
        Image = _pil_image()
        with Image.open(path) as im:
            return _resize_u8(np.asarray(im.convert("RGB")), self.resize)


class SyntheticImageStore:
    """Seeded random (resize, resize, 3) uint8 images, one per item name.

    The seed is a CRC-32 of the name, so an item's image is the same in
    every process (the JAX package's store seeds from ``hash(name)``, which
    Python salts per process)."""

    def __init__(self, resize: int = 224):
        self.resize = resize

    def get(self, name: str) -> np.ndarray:
        rng = np.random.default_rng(zlib.crc32(name.encode()) % (2 ** 31))
        return rng.integers(0, 256, (self.resize, self.resize, 3),
                            dtype=np.uint8)


def open_image_source(path: str, resize: int):
    """The image store ``path`` names, as the JAX package routes it: an
    LMDB (a data file, or a directory holding ``data.mdb``) ->
    ``LmdbImageStore``; another directory -> ``DirImageStore``; nothing at
    ``path`` (or no path) -> ``SyntheticImageStore``, with a warning.  The
    legacy pickle-shim directory (``data.shimdb``) raises."""
    if path and os.path.isfile(os.path.join(path, "data.shimdb")):
        raise RuntimeError(
            f"{path} holds a legacy pickle-shim database (data.shimdb) from "
            "an earlier revision of the JAX package; rebuild it with "
            "python -m iisan_tpu_torch.tools.build_lmdb (output is real "
            "LMDB format)")
    if is_lmdb_path(path):
        return LmdbImageStore(path, resize)
    if path and os.path.isdir(path):
        return DirImageStore(path, resize)
    log.warning("no image source at %r - synthetic images", path)
    return SyntheticImageStore(resize)


class ParallelImageLoader:
    """Decodes batches of item names on a thread pool, ``prefetch``
    batches ahead of the consumer."""

    def __init__(self, store, num_threads: int = 8, prefetch: int = 2):
        self.store = store
        self.pool = ThreadPoolExecutor(max_workers=num_threads)
        self.prefetch = prefetch
        resize = getattr(store, "resize", 224)
        self._pad_image = np.zeros((resize, resize, 3), dtype=np.uint8)

    def iter_batches(self, name_batches: Iterable[Sequence[str]]
                     ) -> Iterator[np.ndarray]:
        """Yields one (len(names), H, W, 3) uint8 array per batch."""
        it = iter(name_batches)
        # The producer submits per-image tasks only (no nested batch tasks
        # on the same pool); the bounded queue paces it to the consumer.
        pending: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()

        def submit_all():
            for names in it:
                pending.put([self.pool.submit(self.store.get, n)
                             if n is not None else None for n in names])
            pending.put(done)

        threading.Thread(target=submit_all, daemon=True).start()
        while True:
            futs = pending.get()
            if futs is done:
                break
            yield np.stack([f.result() if f is not None else self._pad_image
                            for f in futs])


def synthetic_token_table(item_num: int, num_words: int = 30, seed: int = 0,
                          vocab: int = 30000) -> np.ndarray:
    """(item_num + 1, 2 * num_words) int32 packed title rows: random ids in
    [1, vocab) then an all-ones mask; row 0 (the pad item) is all zeros."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((item_num + 1, 2 * num_words), np.int32)
    tokens[1:, :num_words] = rng.integers(1, vocab, size=(item_num, num_words))
    tokens[1:, num_words:] = 1
    return tokens


def build_lmdb(items_tsv: str, image_dir: str, out_path: str,
               commit_every: int = 5000) -> List[str]:
    """Build the reference-layout LMDB at ``out_path`` (a data file) from
    ``<image_dir>/<name>.jpg`` for every name of the item TSV: one pickled
    ``LMDBImage`` (the full-size RGB pixels as Pillow decodes them) per
    name, then ``__keys__`` and ``__len__``.  The names are the first
    column of the TSV as pandas reads it, as in the JAX package.  Returns
    the names whose image could not be opened or decoded, whatever the
    error (the bad-file list).  Intermediate
    commits every ``commit_every`` images with the native ``lmdb``; the
    pure-Python backend rewrites the whole file per commit, so it commits
    once at the end."""
    Image = _pil_image()
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError("pandas is not installed: build_lmdb reads the "
                          "items TSV with it, as the JAX package does") from e
    names = pd.read_table(items_tsv, header=None)[0].tolist()
    env = lmdb.open(out_path, subdir=False, map_size=2 ** 40,
                    readonly=False, meminit=False, map_async=True)
    txn = env.begin(write=True)
    keys, bad = [], []
    for i, name in enumerate(names):
        try:
            with Image.open(os.path.join(image_dir, name + ".jpg")) as im:
                img = np.asarray(im.convert("RGB"))
        except Exception:
            bad.append(name)
            continue
        key = name.encode("ascii")
        txn.put(key, pickle.dumps(LMDBImage(img, name)))
        keys.append(key)
        if (i + 1) % commit_every == 0 and LMDB_BACKEND == "lmdb":
            txn.commit()
            txn = env.begin(write=True)
    txn.put(b"__keys__", pickle.dumps(keys))
    txn.put(b"__len__", pickle.dumps(len(keys)))
    txn.commit()
    env.sync()
    env.close()
    return bad
