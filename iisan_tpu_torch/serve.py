"""Serving: top-K recommendations from a fused item table.

Port of ``iisan_tpu/serve.py``.  The ``Recommender`` holds the fused item
table (built once by ``eval.evaluate.compute_item_tables``) and answers a
request with one pass on the device: gather the sequence rows, run the
user encoder, score the full catalogue, mask the history, take the top-K.

    rec = Recommender(model, fused_table, max_seq_len)
    items, scores = rec.top_k(seq_ids, k=10)   # (B, k) item ids

The artifact written by ``save`` is the JAX package's ``.npz`` format
(``param:user_encoder/...`` keys, ``fused_table``, ``max_seq_len``,
``n_layers``, ``n_heads``; fp32), so artifacts move between the two
packages in both directions.

Command line (input rows ``user_id \\t space-separated item ids``):

    python -m iisan_tpu_torch.serve artifact.npz --input seqs.tsv \\
        --out recs.tsv [--k 10] [--batch 256] [--include-history]
    python -m iisan_tpu_torch.serve artifact.npz --http 127.0.0.1:8000
    curl -X POST :8000/recommend -d '{"sequences": [[5, 17, 102]], "k": 10}'
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .device import resolve_device
from .ops.metrics import mask_history
from .utils.jax_params import export_jax_params, flatten_tree, load_jax_params


@torch.no_grad()
def _topk_step(model, fused_table, table32, tokens, log_mask, history,
               k: int):
    input_embs = fused_table[tokens.long()]
    prec = model.user_scores(input_embs, log_mask)[:, -1, :]
    scores = prec.float() @ table32.T
    scores = mask_history(scores, history)
    scores[:, 0] = float("-inf")  # never recommend the pad item
    top_scores, top_ids = torch.topk(scores, k, dim=1)
    return top_ids, top_scores


class Recommender:
    """Frozen-table batch recommender over one model on one device."""

    def __init__(self, model, fused_table: torch.Tensor, max_seq_len: int):
        self.model = model
        self.fused_table = fused_table
        self._table32 = fused_table.float()  # scoring operand, made once
        self.max_seq_len = max_seq_len

    def _prep(self, seqs, hist_len: int = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Ragged sequences -> left-padded tokens / log_mask / history;
        ``hist_len`` pads the history axis to a caller-chosen width."""
        L = self.max_seq_len
        b = len(seqs)
        tokens = np.zeros((b, L), np.int32)
        log_mask = np.zeros((b, L), np.float32)
        hist_len = max(max((len(s) for s in seqs), default=1), 1,
                       hist_len or 1)
        history = np.zeros((b, hist_len), np.int32)
        for i, s in enumerate(seqs):
            full = list(s)
            last = full[-L:]
            tokens[i, L - len(last):] = last
            log_mask[i, L - len(last):] = 1.0
            history[i, :len(full)] = full
        return tokens, log_mask, history

    def save(self, path: str) -> None:
        """Export the deployable artifact: fused table + user-encoder
        params, stored as fp32 (the JAX package's format)."""
        params = export_jax_params(self.model.user_encoder)
        flat = {f"param:user_encoder/{key}": value
                for key, value in flatten_tree(params, "/").items()}
        np.savez(path, max_seq_len=np.int32(self.max_seq_len),
                 n_layers=np.int32(self.model.user_encoder.n_layers),
                 n_heads=np.int32(self.model.user_encoder.num_attention_heads),
                 fused_table=self.fused_table.float().cpu().numpy(), **flat)

    @classmethod
    def load(cls, path: str, device=None) -> "Recommender":
        """Rebuild a Recommender from a ``save()`` artifact (of either
        package) on ``device`` (default the first CUDA card; the CPU only
        when asked for).  It computes in fp32 over the fp32 table, as the
        JAX package's ``load`` does."""
        from .models.model import IISANRecModel

        device = resolve_device(device)
        with np.load(path) as z:
            params: dict = {}
            for key in z.files:
                if not key.startswith("param:user_encoder/"):
                    continue
                node = params
                parts = key[len("param:user_encoder/"):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = z[key]
            if "fused_table" not in z.files:
                raise ValueError(f"{path} holds no dense fused_table "
                                 "(int8 artifacts are not supported yet)")
            table = torch.as_tensor(z["fused_table"], device=device)
            L, n_layers, n_heads = (int(z[k]) for k in
                                    ("max_seq_len", "n_layers", "n_heads"))
        dim = int(table.shape[-1])
        model = IISANRecModel(san=None, embedding_dim=dim, max_seq_len=L,
                              num_attention_heads=n_heads,
                              transformer_block=n_layers, drop_rate=0.0,
                              dtype=torch.float32, device=device)
        load_jax_params(model.user_encoder, params)
        return cls(model.eval(), table.float(), L)

    def top_k(self, seqs, k: int = 10, exclude_history: bool = True,
              hist_len: int = None) -> Tuple[np.ndarray, np.ndarray]:
        """seqs: item-id sequences (most recent last).  Returns
        (item_ids, scores), each (B, k) numpy; history items are excluded
        by default."""
        tokens, log_mask, history = self._prep(seqs, hist_len)
        if not exclude_history:
            history = np.zeros_like(history)
        dev = self.fused_table.device
        ids, scores = _topk_step(
            self.model, self.fused_table, self._table32,
            torch.as_tensor(tokens, device=dev),
            torch.as_tensor(log_mask, device=dev),
            torch.as_tensor(history, device=dev), k)
        return ids.int().cpu().numpy(), scores.cpu().numpy()


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, capped: requests share a few shapes."""
    b = 1
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


def serve_http(rec: Recommender, host: str, port: int,
               max_batch: int = 256):
    """Online serving: a threaded HTTP server over one Recommender.

    POST /recommend  {"sequences": [[item ids...], ...], "k": 10,
                      "exclude_history": true}
        -> {"items": [[...], ...], "scores": [[...], ...]}
    GET  /healthz    -> {"status": "ok", "catalog_items": N, ...}

    Batch, history and k are bucketed to powers of two; requests to the
    device are serialized with a lock.  Returns the server; call
    ``serve_forever()`` (the CLI does) and ``server_close()`` when done.
    """
    import json
    import logging
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    log = logging.getLogger("iisan_tpu_torch")
    lock = threading.Lock()
    n_items = int(rec.fused_table.shape[0]) - 1
    max_hist = 4096  # longest accepted client sequence

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "catalog_items": n_items,
                                 "max_seq_len": rec.max_seq_len})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/recommend":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                seqs = req["sequences"]
                k = int(req.get("k", 10))
                exclude = bool(req.get("exclude_history", True))
                if (not isinstance(seqs, list) or not seqs
                        or not all(isinstance(s, list) and s for s in seqs)):
                    raise ValueError("sequences must be a non-empty list of "
                                     "non-empty item-id lists")
                if len(seqs) > max_batch:
                    raise ValueError(f"batch {len(seqs)} > max {max_batch}")
                for s in seqs:
                    if len(s) > max_hist:
                        raise ValueError(
                            f"sequence length {len(s)} > max {max_hist}")
                    bad = [i for i in s if not (isinstance(i, int)
                                                and 0 < i <= n_items)]
                    if bad:
                        raise ValueError(f"item id(s) {bad[:5]} out of "
                                         f"range 1..{n_items}")
                if not 0 < k <= n_items:
                    raise ValueError(f"k must be in 1..{n_items}")
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            n = len(seqs)
            b = _bucket(n, max_batch)
            hist = _bucket(max(len(s) for s in seqs), max_hist)
            kb = min(_bucket(k, 1 << 30), n_items)
            padded = seqs + [[1]] * (b - n)
            with lock:
                ids, scores = rec.top_k(padded, k=kb, exclude_history=exclude,
                                        hist_len=hist)
            ids, scores = ids[:n, :k], scores[:n, :k]
            # -inf scores (k beyond the user's unmasked catalogue) are not
            # valid JSON: report those slots as null
            finite = np.isfinite(scores)
            self._send(200, {
                "items": [[int(i) if f else None for i, f in zip(row, frow)]
                          for row, frow in zip(ids, finite)],
                "scores": [[float(s) if f else None for s, f in zip(row, frow)]
                           for row, frow in zip(scores, finite)]})

        def log_message(self, fmt, *args):
            log.info("http %s", fmt % args)

    server = ThreadingHTTPServer((host, port), Handler)
    log.info("serving on %s:%d (catalog %d items)", host, port, n_items)
    return server


def main(argv=None) -> int:
    """Batch-file or HTTP serving over a ``save()`` artifact."""
    import argparse

    ap = argparse.ArgumentParser(
        description="top-K recommendations from a serving artifact")
    ap.add_argument("artifact", help=".npz from Recommender.save")
    ap.add_argument("--input", help="TSV: user_id\\tspace-separated item ids")
    ap.add_argument("--out", help="output TSV: user_id\\ttop-k ids\\tscores")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--include-history", action="store_true",
                    help="allow recommending items already in the history")
    ap.add_argument("--http", metavar="HOST:PORT",
                    help="serve online over HTTP instead of batch-file mode")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; "
                    "'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    rec = Recommender.load(args.artifact, device=args.device)
    if args.http:
        host, _, port = args.http.rpartition(":")
        if not port.isdigit():
            ap.error(f"--http expects HOST:PORT, got {args.http!r}")
        server = serve_http(rec, host or "127.0.0.1", int(port),
                            max_batch=args.batch)
        print(f"serving {args.artifact} on http://{host or '127.0.0.1'}:"
              f"{port} (POST /recommend)", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    if not (args.input and args.out):
        ap.error("--input and --out are required (or use --http)")
    users, seqs = [], []
    with open(args.input) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            user, _, id_str = line.partition("\t")
            users.append(user)
            seqs.append([int(t) for t in id_str.split()])
    if not users:
        open(args.out, "w").close()
        print(f"no input rows in {args.input}; wrote empty {args.out}")
        return 0
    n_items = int(rec.fused_table.shape[0]) - 1
    for u, s in zip(users, seqs):
        if not s:
            raise SystemExit(f"user {u!r} has an empty item history")
        bad = [i for i in s if not 0 < i <= n_items]
        if bad:
            raise SystemExit(f"item id(s) {bad[:5]} out of range "
                             f"1..{n_items} for this artifact")
    hist_len = max(len(s) for s in seqs)
    with open(args.out, "w") as out:
        for start in range(0, len(users), args.batch):
            chunk = seqs[start:start + args.batch]
            n = len(chunk)
            chunk = chunk + [[1]] * (args.batch - n)
            ids, scores = rec.top_k(
                chunk, k=args.k, exclude_history=not args.include_history,
                hist_len=hist_len)
            for u, row_ids, row_sc in zip(users[start:start + n],
                                          ids[:n], scores[:n]):
                out.write(u + "\t" + " ".join(str(int(i)) for i in row_ids)
                          + "\t" + " ".join(f"{s:.5f}" for s in row_sc)
                          + "\n")
    print(f"wrote {len(users)} recommendation rows to {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
