"""Build the item-image LMDB from a directory of JPEGs.

Port of ``iisan_tpu/tools/build_lmdb.py``, with its flags and printed
lines: the reference's record layout (a pickled ``LMDBImage`` keyed by
item name, plus ``__keys__`` / ``__len__``) and its bad-file report, one
name a line.  Writes through ``lmdb`` where installed, else through the
port's pure-Python backend (``data/lmdbfile.py``); the JAX package's
``LmdbImageStore`` reads the output either way.

    python -m iisan_tpu_torch.tools.build_lmdb --items <items.tsv> \\
        --images <jpeg_dir> --out image.lmdb [--commit-every 5000] \\
        [--bad-report lmdb_bad_file.tsv]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", required=True, help="item TSV (name\\ttitle)")
    ap.add_argument("--images", required=True, help="directory of <name>.jpg")
    ap.add_argument("--out", required=True, help="output LMDB path")
    ap.add_argument("--commit-every", type=int, default=5000)
    ap.add_argument("--bad-report", default="lmdb_bad_file.tsv")
    args = ap.parse_args(argv)

    from ..data.images import LMDB_BACKEND, build_lmdb

    if LMDB_BACKEND != "lmdb":
        print("note: 'lmdb' package not installed - using the pure-Python "
              "LMDB-format writer (iisan_tpu_torch/data/lmdbfile.py)")
    bad = build_lmdb(args.items, args.images, args.out,
                     commit_every=args.commit_every)
    print(f"done; {len(bad)} bad files")
    if bad:
        with open(args.bad_report, "w") as f:
            for name in bad:
                f.write(f"{name}\n")
        print(f"bad-file report: {args.bad_report}")


if __name__ == "__main__":
    main()
