"""Serving: top-K recommendations from a fused item table.

Port of ``iisan_tpu/serve.py``.  The ``Recommender`` holds the fused item
table (built once by ``eval.evaluate.compute_item_tables``) and answers a
request with one pass on the device: gather the sequence rows, run the
user encoder, score the full catalogue, mask the history, take the top-K.

    rec = Recommender(model, fused_table, max_seq_len)
    rec = Recommender.from_trainer(trainer)    # or from a trained model
    items, scores = rec.top_k(seq_ids, k=10)   # (B, k) item ids

The artifact written by ``save`` is the JAX package's ``.npz`` format
(``param:user_encoder/...`` keys, ``max_seq_len``, ``n_layers``,
``n_heads``, and the table: ``fused_table`` in fp32, or an int8 table's
``table_q`` (N, 1, D) int8 and ``table_scale`` (N, 1, 1) fp32), so
artifacts move between the two packages in both directions.

``quantize_table`` gives a Recommender over int8 rows and fp32 row scales
(``ops/quant.quantize_taps``): about a quarter of the fp32 table's bytes,
no dense copy kept.  Only the gathered input rows are dequantised, and the
catalogue is scored as ``(prec @ q.T) * s`` in fp32, the row scale applied
after the product, in row chunks (``SCORE_CHUNK``), so the transient stays
bounded.

``ShardedRecommender`` splits the table (fp32, bf16 or int8) by rows over
the ranks of ``torch.distributed``: a request gathers its input rows as a
sum over the ranks of the rows each owns, runs the user encoder on every
rank, scores the rank's rows, and merges each rank's local top-K into the
answer of ``Recommender.top_k`` (ties may reorder).

Command line (input rows ``user_id \\t space-separated item ids``):

    python -m iisan_tpu_torch.serve artifact.npz --input seqs.tsv \\
        --out recs.tsv [--k 10] [--batch 256] [--include-history]
    python -m iisan_tpu_torch.serve artifact.npz --http 127.0.0.1:8000
    curl -X POST :8000/recommend -d '{"sequences": [[5, 17, 102]], "k": 10}'
    python -m iisan_tpu_torch.serve artifact.npz --quant int8 --save-as small.npz
    torchrun --nproc_per_node N -m iisan_tpu_torch.serve artifact.npz --shard \\
        --input seqs.tsv --out recs.tsv      # or --http: rank 0 listens
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .device import resolve_device
from .ops.metrics import mask_history
from .ops.quant import QuantTaps, gather_rows, quantize_taps
from .parallel.distributed import (all_gather_rows, all_reduce_sum, barrier,
                                   broadcast_, initialize_runtime, is_main,
                                   shutdown_runtime)
from .parallel.mesh import make_mesh, world_rank
from .utils.jax_params import export_jax_params, flatten_tree, load_jax_params
from .utils.profiling import annotate

SCORE_CHUNK = 1 << 16  # int8 table rows dequantised per scoring product


def _table_lookup(table, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a dense or int8 table; an int8 table's (N, 1, D)
    rows are dequantised here, and only these."""
    out = gather_rows(table, ids.long())
    return out[..., 0, :] if isinstance(table, QuantTaps) else out


def _score_catalog(prec: torch.Tensor, table, table32=None) -> torch.Tensor:
    """(B, D) user states x the table -> (B, N) fp32 scores.  A dense table
    is one product with its fp32 copy ``table32``; an int8 one is scored
    ``(prec @ q.T) * s`` a chunk of ``SCORE_CHUNK`` rows at a time, the row
    scale applied after the product, so no dequantised table exists."""
    prec = prec.float()
    if not isinstance(table, QuantTaps):
        return prec @ (table32 if table32 is not None else table.float()).T
    n = table.q.shape[0]
    scores = prec.new_empty((prec.shape[0], n))
    for lo in range(0, n, SCORE_CHUNK):
        q = table.q[lo:lo + SCORE_CHUNK, 0, :].float()
        scores[:, lo:lo + SCORE_CHUNK] = (prec @ q.T) * \
            table.scale[lo:lo + SCORE_CHUNK, 0, 0][None, :]
    return scores


def _catalog_rows(rec) -> int:
    """Table rows (catalogue + pad) of a Recommender or ShardedRecommender."""
    return int(rec.n_rows)


@torch.no_grad()
def _topk_step(model, fused_table, table32, tokens, log_mask, history,
               k: int):
    with annotate("iisan.top_k.encode"):
        input_embs = _table_lookup(fused_table, tokens)
        prec = model.user_scores(input_embs, log_mask)[:, -1, :]
    with annotate("iisan.top_k.score"):
        scores = _score_catalog(prec, fused_table, table32)
    with annotate("iisan.top_k.mask"):
        scores = mask_history(scores, history)
        scores[:, 0] = float("-inf")  # never recommend the pad item
    with annotate("iisan.top_k.select"):
        top_scores, top_ids = torch.topk(scores, k, dim=1)
    return top_ids, top_scores


def _tensor_bytes(*tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class Recommender:
    """Frozen-table batch recommender over one model on one device.

    ``fused_table``: a dense (N, D) tensor (scored through an fp32 copy,
    made once; none when it is fp32 already) or an int8 ``QuantTaps`` of
    (N, 1, D) rows (``quantize_table``; no dense copy)."""

    def __init__(self, model, fused_table, max_seq_len: int):
        self.model = model
        self.fused_table = fused_table
        self.quant = isinstance(fused_table, QuantTaps)
        self._table32 = None if self.quant else fused_table.float()
        self.max_seq_len = max_seq_len

    @property
    def n_rows(self) -> int:
        return int(self.fused_table.shape[0])

    @property
    def device(self) -> torch.device:
        return (self.fused_table.q if self.quant else self.fused_table).device

    @property
    def table_bytes(self) -> int:
        """Device bytes the table takes here (copies included)."""
        if self.quant:
            return _tensor_bytes(self.fused_table.q, self.fused_table.scale)
        return _tensor_bytes(self.fused_table, self._table32)

    @classmethod
    def from_trainer(cls, trainer) -> "Recommender":
        """Serve a trainer's model: the cached trainers' fused item table
        (``fused_item_table``), the uncached ones' (``item_embedding_tables``),
        built once from the current weights, or the ID model's embedding
        table (``id_embedding.weight``)."""
        if hasattr(trainer, "fused_item_table"):
            table = trainer.fused_item_table()
        elif hasattr(trainer, "item_embedding_tables"):
            table = trainer.item_embedding_tables()
        else:
            table = trainer.model.id_embedding.weight.detach().clone()
        return cls(trainer.model, table, trainer.cfg.max_seq_len)

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

    def quantize_table(self) -> "Recommender":
        """A Recommender over this one's table as int8 rows and fp32 row
        scales (``ops/quant.quantize_taps``, on the table's device; row
        error at most half a step of absmax / 127).  An int8 one is
        returned as it is."""
        if self.quant:
            return self
        t = quantize_taps(self.fused_table.float()[:, None, :],
                          out_dtype="float32")
        return Recommender(self.model, t, self.max_seq_len)

    def save(self, path: str) -> None:
        """Export the deployable artifact: the table and the user-encoder
        params, stored as fp32 (an int8 table as its ``table_q`` and
        ``table_scale``), the JAX package's format."""
        params = export_jax_params(self.model.user_encoder)
        flat = {f"param:user_encoder/{key}": value
                for key, value in flatten_tree(params, "/").items()}
        if self.quant:
            flat["table_q"] = self.fused_table.q.cpu().numpy()
            flat["table_scale"] = self.fused_table.scale.float().cpu().numpy()
        else:
            flat["fused_table"] = self.fused_table.float().cpu().numpy()
        np.savez(path, max_seq_len=np.int32(self.max_seq_len),
                 n_layers=np.int32(self.model.user_encoder.n_layers),
                 n_heads=np.int32(self.model.user_encoder.num_attention_heads),
                 **flat)

    @classmethod
    def load(cls, path: str, device=None) -> "Recommender":
        """Rebuild a Recommender from a ``save()`` artifact (of either
        package) on ``device`` (default the first CUDA card; the CPU only
        when asked for).  It computes in fp32 over the fp32 table, or over
        the int8 table, as the JAX package's ``load`` does."""
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
            if "table_q" in z.files:
                table = QuantTaps(torch.as_tensor(z["table_q"], device=device),
                                  torch.as_tensor(z["table_scale"],
                                                  device=device).float(),
                                  out_dtype="float32")
            else:
                table = torch.as_tensor(z["fused_table"], device=device).float()
            L, n_layers, n_heads = (int(z[k]) for k in
                                    ("max_seq_len", "n_layers", "n_heads"))
        dim = int(table.shape[-1])
        model = IISANRecModel(san=None, embedding_dim=dim, max_seq_len=L,
                              num_attention_heads=n_heads,
                              transformer_block=n_layers, drop_rate=0.0,
                              dtype=torch.float32, device=device)
        load_jax_params(model.user_encoder, params)
        return cls(model.eval(), table, L)

    def top_k(self, seqs, k: int = 10, exclude_history: bool = True,
              hist_len: int = None) -> Tuple[np.ndarray, np.ndarray]:
        """seqs: item-id sequences (most recent last).  Returns
        (item_ids, scores), each (B, k) numpy; history items are excluded
        by default."""
        with annotate("iisan.top_k"):
            with annotate("iisan.top_k.prep"):
                tokens, log_mask, history = self._prep(seqs, hist_len)
                if not exclude_history:
                    history = np.zeros_like(history)
            dev = self.device
            with annotate("iisan.top_k.upload"):
                args = [torch.as_tensor(a, device=dev)
                        for a in (tokens, log_mask, history)]
            ids, scores = _topk_step(self.model, self.fused_table,
                                     self._table32, *args, k)
            with annotate("iisan.top_k.fetch"):
                return ids.int().cpu().numpy(), scores.cpu().numpy()


class ShardedRecommender:
    """A Recommender's table split by rows over the ranks of
    ``torch.distributed`` (the JAX package's catalogue-sharded serving).

    The table (fp32, bf16 kept in bf16, or int8 rows with their scales) is
    padded to a multiple of the axis and each rank keeps ``rows_local``
    rows from ``index * rows_local``.  A request (every rank calls
    ``top_k`` with the same arguments) gathers its input rows as a sum
    over the axis of the rows each rank owns, runs the user encoder on
    every rank (replicated), scores the rank's rows, masks padding, the pad
    item and history where they fall in the shard, takes a local top
    ``min(k, rows_local)`` and merges the all-gathered candidates: the
    ids and scores of ``Recommender.top_k`` (ties may reorder).  ``mesh``
    must have one axis; default every rank on one ``model`` axis.
    """

    def __init__(self, rec: Recommender, mesh=None, axis: str = None):
        mesh = mesh if mesh is not None else make_mesh(f"model:{world_rank()[0]}")
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedRecommender takes a 1-D mesh; got "
                             f"{mesh.axis_names}")
        self.axis = mesh.axis(axis or mesh.axis_names[-1])
        self.model, self.max_seq_len = rec.model, rec.max_seq_len
        self.quant = rec.quant
        self.n_rows = rec.n_rows
        self.rows_local = -(-self.n_rows // self.axis.size)
        self.offset = self.axis.index * self.rows_local
        rows = slice(self.offset, min(self.offset + self.rows_local, self.n_rows))
        pad = self.rows_local - (rows.stop - rows.start)
        src = rec.fused_table

        def padded(t):
            return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

        self.table = (QuantTaps(padded(src.q[rows]), padded(src.scale[rows].float()),
                                "float32") if self.quant else padded(src[rows]))
        broadcast_(self.model.state_dict().values())
        self._prep = Recommender._prep.__get__(self)

    @property
    def device(self) -> torch.device:
        return (self.table.q if self.quant else self.table).device

    @property
    def table_bytes(self) -> int:
        """Device bytes of this rank's rows."""
        if self.quant:
            return _tensor_bytes(self.table.q, self.table.scale)
        return _tensor_bytes(self.table)

    @torch.no_grad()
    def _step(self, tokens, log_mask, history, k: int):
        Nl, off = self.rows_local, self.offset
        loc = tokens.long() - off
        mine = (loc >= 0) & (loc < Nl)
        emb = _table_lookup(self.table, torch.where(mine, loc, torch.zeros_like(loc)))
        # one rank holds each row: an fp32 sum of it and zeros is exact
        emb = all_reduce_sum(torch.where(mine[..., None], emb.float(),
                                         torch.zeros_like(emb, dtype=torch.float32)),
                             self.axis).to(emb.dtype)
        prec = self.model.user_scores(emb, log_mask)[:, -1, :]
        scores = _score_catalog(prec, self.table)
        gids = off + torch.arange(Nl, device=scores.device)
        scores[:, (gids >= self.n_rows) | (gids == 0)] = float("-inf")
        # history: a boolean of the ids inside this shard, never an index
        # with a negative (which would wrap to the shard's end)
        hist = history.long() - off
        inside = (hist >= 0) & (hist < Nl)
        users = torch.arange(hist.shape[0], device=hist.device)[:, None]
        scores[users.expand_as(hist)[inside], hist[inside]] = float("-inf")
        top_s, top_i = torch.topk(scores, min(k, Nl), dim=1)
        B = scores.shape[0]
        all_s = all_gather_rows(top_s, self.axis).reshape(self.axis.size, B, -1)
        all_i = all_gather_rows(top_i + off, self.axis).reshape(
            self.axis.size, B, -1)
        all_s = all_s.transpose(0, 1).reshape(B, -1)
        all_i = all_i.transpose(0, 1).reshape(B, -1)
        fin_s, pos = torch.topk(all_s, k, dim=1)
        return all_i.gather(1, pos), fin_s

    def top_k(self, seqs, k: int = 10, exclude_history: bool = True,
              hist_len: int = None) -> Tuple[np.ndarray, np.ndarray]:
        """``Recommender.top_k``; every rank calls it with the same
        arguments."""
        tokens, log_mask, history = self._prep(seqs, hist_len)
        if not exclude_history:
            history = np.zeros_like(history)
        if not 0 < k < self.n_rows:
            raise ValueError(f"k must be in 1..{self.n_rows - 1}")
        dev = self.device
        ids, scores = self._step(torch.as_tensor(tokens, device=dev),
                                 torch.as_tensor(log_mask, device=dev),
                                 torch.as_tensor(history, device=dev), k)
        return ids.int().cpu().numpy(), scores.cpu().numpy()


class _Leader:
    """Rank 0's view of a ShardedRecommender served over HTTP at a world of
    more than one: each ``top_k`` broadcasts its arguments to the other
    ranks (``follow``) first.  ``heartbeat`` broadcasts nothing to do, so
    an idle server's followers never wait past the group's timeout."""

    def __init__(self, rec: "ShardedRecommender"):
        self.rec = rec
        self.n_rows, self.max_seq_len = rec.n_rows, rec.max_seq_len

    @staticmethod
    def _send(msg) -> None:
        torch.distributed.broadcast_object_list([msg], src=0)

    def top_k(self, seqs, k: int = 10, exclude_history: bool = True,
              hist_len: int = None):
        self._send(("top_k", seqs, k, exclude_history, hist_len))
        return self.rec.top_k(seqs, k, exclude_history, hist_len)

    def heartbeat(self) -> None:
        self._send(("noop",))

    def stop(self) -> None:
        self._send(("stop",))


def follow(rec: "ShardedRecommender") -> None:
    """A rank other than 0 of an HTTP-served ShardedRecommender: run each
    request rank 0 broadcasts until it says stop."""
    while True:
        msg = [None]
        torch.distributed.broadcast_object_list(msg, src=0)
        if msg[0][0] == "stop":
            return
        if msg[0][0] == "top_k":
            rec.top_k(*msg[0][1:])


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, capped: requests share a few shapes."""
    b = 1
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


def serve_http(rec, host: str, port: int, max_batch: int = 256):
    """Online serving: a threaded HTTP server over one Recommender (or a
    ShardedRecommender, or rank 0's ``_Leader`` of one: the same query
    surface).

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
    n_items = _catalog_rows(rec) - 1
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
    server.lock = lock  # serialises a _Leader's heartbeats with requests
    log.info("serving on %s:%d (catalog %d items)", host, port, n_items)
    return server


def _serve_forever(rec, args, ap) -> None:
    """``--http``: serve until interrupted.  At a world of more than one
    with ``--shard``, rank 0 listens and leads; the others ``follow``."""
    import threading

    world, rank = world_rank()
    if rank != 0:
        follow(rec)
        return
    host, _, port = args.http.rpartition(":")
    if not port.isdigit():
        ap.error(f"--http expects HOST:PORT, got {args.http!r}")
    leader = _Leader(rec) if world > 1 else None
    server = serve_http(leader or rec, host or "127.0.0.1", int(port),
                        max_batch=args.batch)
    stop = threading.Event()

    def heartbeats():
        while not stop.wait(HEARTBEAT_S):
            with server.lock:
                leader.heartbeat()

    beat = threading.Thread(target=heartbeats, daemon=True)
    if leader is not None:
        beat.start()
    print(f"serving {args.artifact} on http://{host or '127.0.0.1'}:"
          f"{port} (POST /recommend)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if leader is not None:
            stop.set()
            beat.join()
            with server.lock:
                leader.stop()


HEARTBEAT_S = 30.0  # an idle HTTP leader's broadcast interval


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
    ap.add_argument("--shard", action="store_true",
                    help="split the table by rows over the ranks of a "
                    "torchrun launch (ShardedRecommender): every rank "
                    "scores its rows; rank 0 writes the output or listens")
    ap.add_argument("--quant", choices=["none", "int8"], default="none",
                    help="int8: serve from int8 rows and fp32 row scales "
                    "(about a quarter of the fp32 table's memory)")
    ap.add_argument("--save-as", metavar="OUT.npz",
                    help="write the (e.g. --quant int8) artifact and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card, the "
                    "card of LOCAL_RANK under torchrun; 'cpu' runs on the "
                    "CPU, over gloo with --shard)")
    args = ap.parse_args(argv)

    if args.shard:
        initialize_runtime(device=args.device)
    try:
        return _serve(args, ap)
    finally:
        shutdown_runtime()


def _serve(args, ap) -> int:
    rec = Recommender.load(args.artifact, device=args.device)
    if args.quant == "int8":
        rec = rec.quantize_table()
    if args.save_as:
        if is_main():
            rec.save(args.save_as)
            print(f"re-exported {args.artifact} -> {args.save_as} "
                  f"(quant={args.quant})")
        barrier()
        return 0
    if args.shard:
        rec = ShardedRecommender(rec)
    if args.http:
        _serve_forever(rec, args, ap)
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
        if is_main():
            open(args.out, "w").close()
            print(f"no input rows in {args.input}; wrote empty {args.out}")
        return 0
    n_items = _catalog_rows(rec) - 1
    for u, s in zip(users, seqs):
        if not s:
            raise SystemExit(f"user {u!r} has an empty item history")
        bad = [i for i in s if not 0 < i <= n_items]
        if bad:
            raise SystemExit(f"item id(s) {bad[:5]} out of range "
                             f"1..{n_items} for this artifact")
    hist_len = max(len(s) for s in seqs)
    rows = []
    for start in range(0, len(users), args.batch):
        chunk = seqs[start:start + args.batch]
        n = len(chunk)
        chunk = chunk + [[1]] * (args.batch - n)
        ids, scores = rec.top_k(
            chunk, k=args.k, exclude_history=not args.include_history,
            hist_len=hist_len)
        for u, row_ids, row_sc in zip(users[start:start + n], ids[:n],
                                      scores[:n]):
            rows.append(u + "\t" + " ".join(str(int(i)) for i in row_ids)
                        + "\t" + " ".join(f"{s:.5f}" for s in row_sc) + "\n")
    if is_main():
        with open(args.out, "w") as out:
            out.writelines(rows)
        print(f"wrote {len(users)} recommendation rows to {args.out}")
    barrier()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
