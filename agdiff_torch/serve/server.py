"""Persistent generation service (port of agdiff_tpu/serve/server.py).

The service loads a checkpoint once, warms the ladders it will serve
(GenerationRunner.warm, which on a card captures each ladder's CUDA
graphs: sampling/graphed.py), and answers generation requests over a TCP
socket, so that a request costs the ladder's replays and not a capture.

Protocol (the JAX service's): newline-delimited JSON, one request per
connection, one JSON line back, always with an "ok" field:

  {"cmd": "ping"}
  {"cmd": "warm", "nodes": [24, 48], "num_samples": 64, "retry": false}
  {"cmd": "generate", "test_set": "mols.npz", "out_dir": "out",
   "num_confs": "2x", "seed": 2021, "start_idx": 0, "end_idx": null,
   "resume": true}
  {"cmd": "generate", "synthetic": 8, "synthetic_seed": 7,
   "synthetic_chem": "rich", "out_dir": "out"}
  {"cmd": "evaluate", "samples": "out/samples_all.npz", "ratio": 2}
  {"cmd": "shutdown"}

A failed request replies with its traceback and the server keeps
serving; a molecule above `max_nodes` is rejected with a one-line message
and `rejected: "over_capacity"` before any device work.

Dynamic batching (batch_window_s > 0, with a PackedGenerationRunner):
"generate" requests that arrive within the window are merged into one
packed run, ordered by seed; each request's starts are drawn from its own
(seed, molecule) item seeds, so with a noise-free ladder (DDIM at eta 0)
its samples are those it gets alone, bit for bit where the chunk's batch
size is the same. A request opts out with "batch": false.

What differs from the JAX service, and why:

* Warmed graphs stay warm. On a TPU a warmed ladder program depends only
  on shapes, so warming one molecule per (bucket, capacity) class covers
  the class. On the card a ladder is a set of CUDA graphs, and a tight
  engine's graphs hold one pair list, which depends on the atom count
  (ops/pairs.py, PairList.key). The runner keeps every graph `warm`
  captured (Sampler.pinned), and `warm_classes` keys a tight engine's
  classes by (bucket, capacity, atom count), so each warmed set of graphs
  serves every molecule of its class. Capturing once per (bucket,
  capacity) would need the pair list as a fixed-size graph input
  (ROADMAP.md queue 1). Each ladder's graphs hold a memory pool (26-858
  MiB at full width, PERF.md); the server logs the warmed pools' total.
* One device lock. The JAX service answers warm, ping and unbatched
  generate requests on the accept thread while the batch worker runs a
  merged one. Under torch.cuda.graph another thread's CUDA work during a
  capture is an error, so every handler that touches the runner or the
  device holds `device_lock`: the port's form of "single-threaded by
  design". Pure host replies (ping, rejects, bad JSON) and evaluate (host
  numpy and C++) do not wait on it.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import socket
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from agdiff_torch.chem.constants import BondType
from agdiff_torch.chem.mol import Molecule
from agdiff_torch.eval.generate import PackedGenerationRunner


class OverCapacityError(ValueError):
    """A request asked for a molecule larger than the server's max_nodes:
    a designed rejection, not a failure. Replies carry
    ``rejected: "over_capacity"`` and a one-line message instead of a
    traceback."""


def _reject_reply(exc: OverCapacityError) -> dict:
    return {"ok": False, "error": str(exc), "rejected": "over_capacity"}


def probe_molecule(num_nodes: int) -> Molecule:
    """A linear carbon chain of `num_nodes` atoms: the cheapest molecule of
    a size class, for warming. It covers every molecule of its bucket on
    a triu engine; on a tight engine, those of its atom count."""
    n = max(int(num_nodes), 2)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = np.arange(n) * 1.52
    pos -= pos.mean(0, keepdims=True)
    src = np.repeat(np.arange(n - 1), 2)
    dst = src.copy()
    src[0::2] = np.arange(n - 1)
    dst[0::2] = np.arange(1, n)
    src[1::2] = np.arange(1, n)
    dst[1::2] = np.arange(n - 1)
    return Molecule(
        atom_type=np.full((n,), 6, np.int32),
        pos=pos,
        bond_index=np.stack([src, dst]).astype(np.int32),
        bond_type=np.full((2 * (n - 1),), int(BondType.SINGLE), np.int32),
        smiles=f"PROBE-{n}",
    )


def warm_classes(runner, molecules) -> dict:
    """Group molecules into the classes whose ladders `runner` would
    capture, keeping the largest molecule of each as the one to warm:
    (bucket, None, None) on a triu engine, (bucket, capacity, atom count)
    on a tight one, whose graphs hold the molecule's pair list (the JAX
    service groups by (bucket, capacity), module docstring). Used by
    `cli.serve --warm_set`."""
    classes: dict = {}
    for m in molecules:
        b = runner._bucket_for(m)
        cap = runner._capacity_for(m, runner._engine_for(b))
        key = (b, cap, None if cap is None else m.num_nodes)
        prev = classes.get(key)
        if prev is None or m.num_nodes > prev.num_nodes:
            classes[key] = m
    return classes


class GenerationService:
    """Request handler around a (pre-built) GenerationRunner."""

    def __init__(self, runner, logger=None, batch_window_s: float = 0.0,
                 max_nodes: Optional[int] = None):
        self.runner = runner
        self.group = getattr(runner, "group", None)
        # the followers wait for the next call here (`follow`)
        self.control = None if self.group is None else self.group.control()
        self._released = False
        self.logger = logger
        self.started = time.time()
        self.requests = 0
        self.batch_window_s = float(batch_window_s)
        # a molecule above every warmed size would capture new graphs
        # mid-request; with max_nodes it is rejected before device work
        self.max_nodes = int(max_nodes) if max_nodes else None
        # merging needs the packed runner's per-item seeds and counts
        if self.batch_window_s > 0 and not isinstance(
                runner, PackedGenerationRunner):
            raise ValueError(
                "dynamic batching requires a PackedGenerationRunner "
                "(cli.serve: pass --packed with --batch_window)")
        self.device_lock = threading.Lock()
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._worker: Optional[threading.Thread] = None

    # ---- request handlers ----

    def handle(self, request: dict) -> dict:
        cmd = request.get("cmd")
        self.requests += 1
        try:
            if cmd == "ping":
                return self._ping()
            if cmd == "warm":
                return self._warm(request)
            if cmd == "generate":
                return self._generate(request)
            if cmd == "evaluate":
                return self._evaluate(request)
            if cmd == "shutdown":
                return {"ok": True, "shutdown": True}
            return {"ok": False, "error": f"unknown cmd: {cmd!r}"}
        except OverCapacityError as e:
            return _reject_reply(e)
        except Exception:
            return {"ok": False, "error": traceback.format_exc()}

    def _ping(self) -> dict:
        """Host state only; `cached_programs` counts the captured
        ladders."""
        return {
            "ok": True,
            "uptime_s": round(time.time() - self.started, 3),
            "requests": self.requests,
            "cached_programs": self.runner.ladders(),
            "buckets": list(self.runner.buckets),
        }

    def _warm(self, request: dict) -> dict:
        t0 = time.time()
        captured = []
        with self.device_lock:
            for n in request.get("nodes", []):
                captured += self.call(
                    "warm",
                    probe_molecule(int(n)),
                    num_samples=request.get("num_samples"),
                    retry=bool(request.get("retry", False)),
                    # a merged burst can land on any batch size
                    all_sizes=bool(request.get(
                        "all_sizes", self.batch_window_s > 0)),
                )
        return {
            "ok": True,
            "compiled": [list(c) for c in captured],
            "seconds": round(time.time() - t0, 3),
        }

    def _check_capacity(self, molecules):
        """Reject over-capacity molecules cleanly (see __init__)."""
        if self.max_nodes is None:
            return molecules
        for m in molecules:
            if m.num_nodes > self.max_nodes:
                raise OverCapacityError(
                    f"molecule {getattr(m, 'smiles', '?')!r} has "
                    f"{m.num_nodes} atoms > server capacity "
                    f"{self.max_nodes} (serve --max_nodes); request "
                    "rejected — start a server warmed for larger buckets")
        return molecules

    def _load_dataset(self, request: dict):
        if request.get("test_set"):
            from agdiff_torch.data.dataset import PackedConformationDataset

            return self._check_capacity(
                PackedConformationDataset(request["test_set"]).molecules)
        if request.get("synthetic"):
            from agdiff_torch.data.synthetic import (
                heavy_range,
                synthetic_dataset,
            )

            kw = {}
            if request.get("synthetic_heavy") is not None:
                lo, hi = heavy_range(int(request["synthetic_heavy"]))
                kw = dict(min_heavy=lo, max_heavy=hi)
            return self._check_capacity(synthetic_dataset(
                int(request["synthetic"]),
                seed=int(request.get("synthetic_seed", 7)),
                num_conformers=int(request.get("num_conformers", 3)),
                chem=request.get("synthetic_chem", "tree"),
                **kw,
            ))
        raise ValueError("generate needs 'test_set' or 'synthetic'")

    def _generate(self, request: dict) -> dict:
        """save=false keeps the request in memory (no npz writes);
        return_pos=true inlines the conformers in the reply as nested
        lists (pos[mol][sample][atom][xyz], float32 values)."""
        save = bool(request.get("save", True))
        return_pos = bool(request.get("return_pos", False))
        out_dir = request.get("out_dir")
        if not out_dir:
            if save:
                raise ValueError("generate needs 'out_dir' (or 'save': false)")
            out_dir = "."
        dataset = self._load_dataset(request)
        t0 = time.time()
        with self.device_lock:
            results = self.call(
                "run",
                dataset,
                out_dir,
                seed=int(request.get("seed", 2021)),
                num_confs=request.get("num_confs", "2x"),
                start_idx=int(request.get("start_idx", 0)),
                end_idx=request.get("end_idx"),
                resume=bool(request.get("resume", True)),
                save=save,
            )
        reply = {
            "ok": True,
            "molecules": len(results),
            "samples": sum(int(np.asarray(m.meta["pos_gen"]).shape[0])
                           for m in results if "pos_gen" in m.meta),
            "seconds": round(time.time() - t0, 3),
        }
        if save:
            reply["out"] = f"{out_dir}/samples_all.npz"
        if return_pos:
            reply["pos"] = [np.asarray(m.meta["pos_gen"], np.float32).tolist()
                            for m in results]
        return reply

    def _evaluate(self, request: dict) -> dict:
        """COV/MAT over a samples npz (a generate reply's "out"):
        {"cmd": "evaluate", "samples": ".../samples_all.npz", "ratio": 2}.
        Host work: no device lock."""
        from agdiff_torch.eval.covmat import CovMatEvaluator
        from agdiff_torch.eval.generate import load_samples

        path = request.get("samples")
        if not path:
            raise ValueError("evaluate needs 'samples'")
        data_list = load_samples(path)
        evaluator = CovMatEvaluator(
            num_workers=int(request.get("num_workers", 8)),
            ratio=int(request.get("ratio", 2)),
            print_fn=lambda *a: None,
        )
        t0 = time.time()
        results = evaluator(data_list,
                            start_idx=int(request.get("start_idx", 0)))
        # MAT-* per molecule; COV-* at the reference's headline thresholds
        # (QM9 0.5 A, Drugs 1.25 A, the nearest of the evaluator's)
        stats = {
            "MAT-R_mean": float(np.mean(results.MatchingR)),
            "MAT-P_mean": float(np.mean(results.MatchingP)),
        }
        for thr in (0.5, 1.25):
            k = int(np.argmin(np.abs(results.thresholds - thr)))
            stats[f"COV-R_mean@{thr}"] = float(
                np.mean(results.CoverageR[:, k]))
            stats[f"COV-P_mean@{thr}"] = float(
                np.mean(results.CoverageP[:, k]))
        return {
            "ok": True,
            "molecules": len(data_list),
            "seconds": round(time.time() - t0, 3),
            **{k: round(v, 4) for k, v in stats.items()},
        }

    def call(self, name: str, *args, **kwargs):
        """runner.<name>(*args, **kwargs), made on every other rank of the
        runner's group too (`follow`). The caller holds device_lock."""
        if self.group is None:
            return getattr(self.runner, name)(*args, **kwargs)
        self.control.broadcast_object((name, args, kwargs))
        return call_on_every_rank(self.runner, name, args, kwargs)

    def release_followers(self) -> None:
        """End `follow` on the other ranks (once)."""
        if self.group is not None and not self._released:
            self._released = True
            with self.device_lock:
                self.control.broadcast_object(None)

    # ---- dynamic batching ----

    def _batch_worker(self) -> None:
        """Waits for one generate request, collects for batch_window_s,
        then runs the merged batch. Exits on the (None, None) sentinel
        after flushing what was queued."""
        stop = False
        while not stop:
            item = self._queue.get()
            if item[0] is None:
                break
            pending = [item]
            deadline = time.time() + self.batch_window_s
            while True:
                t = deadline - time.time()
                if t <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=t)
                except queue_mod.Empty:
                    break
                if nxt[0] is None:
                    stop = True
                    break
                pending.append(nxt)
            self._run_merged(pending)

    def _run_merged(self, pending) -> None:
        """One packed run over every pending request's molecules, ordered
        by seed (so a request set always forms the same chunks), each
        request's starts keyed by its own (seed, molecule index)."""
        from agdiff_torch.eval.generate import _save_all, _save_with_gen

        order = sorted(range(len(pending)),
                       key=lambda j: int(pending[j][1].get("seed", 2021)))
        mols, confs, item_seeds, owners = [], [], [], []
        for j in order:
            conn, req = pending[j]
            try:
                dataset = self._load_dataset(req)
            except OverCapacityError as e:
                self._send(conn, _reject_reply(e))
                conn.close()
                continue
            except Exception:
                self._send(conn, {"ok": False,
                                  "error": traceback.format_exc()})
                conn.close()
                continue
            seed = int(req.get("seed", 2021))
            start = len(mols)
            for k, m in enumerate(dataset):
                mols.append(m)
                confs.append(self.runner.num_samples_for(
                    m, req.get("num_confs", "2x")))
                item_seeds.append((seed, k))
            owners.append((conn, req, start, len(dataset)))
        if not mols:
            return
        self.requests += len(owners)
        t0 = time.time()
        try:
            with self.device_lock:
                results = self.call(
                    "run", mols, None, num_confs=confs, item_seeds=item_seeds,
                    save=False, resume=False)
        except Exception:
            err = {"ok": False, "error": traceback.format_exc()}
            for conn, _, _, _ in owners:
                self._send(conn, err)
                conn.close()
            return
        dt = time.time() - t0
        for conn, req, start, count in owners:
            try:
                sub = results[start:start + count]
                reply = {
                    "ok": True,
                    "molecules": count,
                    "samples": int(sum(
                        np.asarray(m.meta["pos_gen"]).shape[0]
                        for m in sub)),
                    "seconds": round(dt, 3),
                    "batched_with": len(owners) - 1,
                }
                out_dir = req.get("out_dir")
                if bool(req.get("save", True)) and out_dir:
                    os.makedirs(out_dir, exist_ok=True)
                    for k, m in enumerate(sub):
                        _save_with_gen(
                            os.path.join(out_dir, f"samples_{k}.npz"),
                            m, np.asarray(m.meta["pos_gen"], np.float32))
                    _save_all(os.path.join(out_dir, "samples_all.npz"), sub)
                    reply["out"] = f"{out_dir}/samples_all.npz"
                if bool(req.get("return_pos", False)):
                    reply["pos"] = [
                        np.asarray(m.meta["pos_gen"], np.float32).tolist()
                        for m in sub
                    ]
            except Exception:
                reply = {"ok": False, "error": traceback.format_exc()}
            self._send(conn, reply)
            conn.close()

    # ---- transport ----

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              ready_callback=None) -> None:
        """Blocking accept loop, one JSON-line request per connection.
        ready_callback(bound_port) fires once listening (port=0 binds an
        ephemeral port)."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(8)
        bound = srv.getsockname()[1]
        if self.logger:
            self.logger.info(
                "serving on %s:%d; %d ladders warm, their graph pools "
                "%.1f MiB", host, bound, self.runner.ladders(),
                self.runner.warmed_pool_bytes() / 2 ** 20)
        if self.batch_window_s > 0:
            self._worker = threading.Thread(target=self._batch_worker,
                                            daemon=True)
            self._worker.start()
        if ready_callback:
            ready_callback(bound)
        try:
            while True:
                conn, _ = srv.accept()
                request, bad = self._read_request(conn)
                if bad is not None:
                    self._send(conn, bad)
                    conn.close()
                    continue
                if (self.batch_window_s > 0
                        and request.get("cmd") == "generate"
                        and bool(request.get("batch", True))):
                    self._queue.put((conn, request))  # the worker replies
                    continue
                reply = self.handle(request)
                self._send(conn, reply)
                conn.close()
                if reply.get("shutdown"):
                    break
        finally:
            if self._worker is not None:
                self._queue.put((None, None))
                self._worker.join(timeout=600)
            srv.close()
            self.release_followers()

    def _read_request(self, conn):
        """Returns (request, None) or (None, error_reply)."""
        data = b""
        conn.settimeout(60.0)
        try:
            while not data.endswith(b"\n"):
                chunk = conn.recv(1 << 16)
                if not chunk:
                    break
                data += chunk
            request = json.loads(data.decode() or "{}")
        except json.JSONDecodeError as e:
            return None, {"ok": False, "error": f"bad json: {e}"}
        except OSError as e:
            return None, {"ok": False, "error": f"recv failed: {e}"}
        return request, None

    def _send(self, conn, reply: dict) -> None:
        try:
            conn.sendall((json.dumps(reply) + "\n").encode())
        except OSError:
            # the client hung up while we generated; keep serving
            if self.logger:
                self.logger.warning("client disconnected before reply")


class RanksDisagree(RuntimeError):
    """A runner call failed on some ranks of a data-parallel server and
    not on others: their collectives no longer pair up, so the world
    ends."""


def call_on_every_rank(runner, name: str, args, kwargs):
    """runner.<name>(*args, **kwargs) on this rank, then the ranks'
    outcomes compared: a call that failed on every rank (the same inputs
    fail alike) raises its error, and the server goes on; one that failed
    on some ranks only raises RanksDisagree."""
    group = runner.group
    error = None
    try:
        result = getattr(runner, name)(*args, **kwargs)
    except Exception as e:
        error = e
    failed = int(group.all_reduce(torch.tensor(
        [float(error is not None)], device=group.device)).item())
    if 0 < failed < group.world_size:
        raise RanksDisagree(
            f"{name} failed on {failed} of {group.world_size} ranks "
            f"(on rank {group.rank}: {error!r})") from error
    if error is not None:
        raise error
    return result


def follow(runner, logger=None) -> None:
    """A rank other than 0 of a data-parallel server: make each runner
    call rank 0's service makes (GenerationService.call), until it ends
    the service. It waits for each call in the control group, which
    outlasts any pause between requests. A call that failed on every rank
    is logged here and answered by rank 0; RanksDisagree leaves this rank,
    and `launch` then ends the world."""
    control = runner.group.control()
    while True:
        message = control.broadcast_object()
        if message is None:
            return
        name, args, kwargs = message
        try:
            call_on_every_rank(runner, name, args, kwargs)
        except RanksDisagree:
            raise
        except Exception:
            if logger:
                logger.warning("rank %d: %s failed:\n%s", control.rank,
                               name, traceback.format_exc())


def submit(request: dict, host: str = "127.0.0.1", port: int = 7521,
           timeout: Optional[float] = None) -> dict:
    """Client: send one request, return the parsed reply."""
    with socket.create_connection((host, port), timeout=timeout) as conn:
        conn.sendall((json.dumps(request) + "\n").encode())
        data = b""
        while not data.endswith(b"\n"):
            chunk = conn.recv(1 << 16)
            if not chunk:
                break
            data += chunk
    return json.loads(data.decode())
