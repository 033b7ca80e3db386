"""Resident device index server (`gpuserver`).

Port of mmseqs2_tpu/server/device_server.py (reference src/util/gpuserver.cpp
+ src/commons/GpuUtil.h): a persistent process that keeps the padded target
DB resident on the card and serves gapless and gapped scans to
`ungappedprefilter` / `gappedprefilter --gpu 1`, so that each invocation
skips the upload and the kernels' build.

The wire format is the JAX package's, so a client of either package can talk
to a server of either: a unix-domain socket whose path is a hash of the DB
path (as GPUSharedMemory::getShmHash names its segment), messages of an
8-byte little-endian length and a pickle, requests {"op": "scan", "profile",
"cap", "mode", "go", "ge"}, {"op": "ping"} and {"op": "shutdown"}, replies
{"scores": (n_targets,) int32 in DB order} or {"ok": True, ...}. A scan that
fails on the server is answered with {"error": text}, which the client
raises. This server's ping reply also carries its kernel launch counts
("launches"), so that a client can show which kernels served it.
"""

import hashlib
import os
import pickle
import signal
import socket
import struct

import numpy as np
import torch

from ..db import dbtype as dbt
from ..utils import log

MODE_GAPLESS = 0
MODE_GAPPED = 1


def socket_path_for(db_path: str) -> str:
    h = hashlib.sha256(os.path.abspath(db_path).encode()).hexdigest()[:16]
    base = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"
    return os.path.join(base, f"mmseqs2tpu_srv_{h}.sock")


def _send(conn, obj):
    blob = pickle.dumps(obj, protocol=4)
    conn.sendall(struct.pack("<Q", len(blob)) + blob)


def _recv(conn):
    hdr = b""
    while len(hdr) < 8:
        part = conn.recv(8 - len(hdr))
        if not part:
            return None
        hdr += part
    (n,) = struct.unpack("<Q", hdr)
    buf = bytearray()
    while len(buf) < n:
        part = conn.recv(min(1 << 20, n - len(buf)))
        if not part:
            return None
        buf += part
    return pickle.loads(bytes(buf))


class DeviceIndexServer:
    def __init__(self, db_path: str, submat, device=None):
        from ..commands.common import EncodedDB, open_seq_db
        from ..commands.prefilter_cmd import TargetStore, bucket_plan
        from ..device import get_device

        self.db_path = db_path
        reader = open_seq_db(db_path)
        if not (reader.extended_type & dbt.DBTYPE_EXTENDED_GPU):
            log.die(f"Database {os.path.basename(db_path)} is not a valid "
                    f"padded database\nPlease call: makepaddedseqdb "
                    f"{os.path.basename(db_path)} "
                    f"{os.path.basename(db_path)}_pad")
        self.n_targets = reader.size
        device = torch.device(get_device() if device is None else device)
        tdb = EncodedDB(reader, submat)
        _, bucket, order = bucket_plan(tdb)
        if device.type == "cuda":
            # the server holds the whole DB, as the JAX package's does
            free, _ = torch.cuda.mem_get_info(device)
            if int(bucket.sum()) > 0.8 * free:
                raise RuntimeError(
                    f"gpuserver: the padded target DB takes "
                    f"{int(bucket.sum())} bytes, the card has {free} free; "
                    f"a server holds the whole DB (run the prefilter "
                    f"without --gpu 1: it uploads the DB in chunks)")
        self.store = TargetStore(tdb, device, order)
        log.info(f"Device index resident: {reader.size} targets in "
                 f"{len(self.store.blocks)} length buckets on "
                 f"{self.store.device}")

    def scan(self, profile, cap, mode, go=11, ge=1):
        """profile: (A, Lq) int; returns scores (n_targets,) in DB order.
        Both modes run the score-only kernel (gapless_score, sw_score)."""
        flat = self.store.scan(np.asarray(profile, np.int32), cap, mode, go,
                               ge, track=False)
        return self.store.in_db_order(flat.cpu().numpy())

    @staticmethod
    def launches():
        """Kernel launches of this process, by wrapper."""
        from ..ops import gapless, sw
        return {"gapless_score": gapless.gapless_score.launches,
                "sw_single": sw.sw_single.launches,
                "sw_score": sw.sw_score.launches}

    def serve(self):
        path = socket_path_for(self.db_path)
        if os.path.exists(path):
            os.unlink(path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(path)
        srv.listen(16)
        running = {"on": True}

        def stop(signum, frame):
            running["on"] = False
            srv.close()

        signal.signal(signal.SIGINT, stop)
        signal.signal(signal.SIGTERM, stop)
        log.info(f"gpuserver listening on {path}")
        print(path, flush=True)
        try:
            while running["on"]:
                try:
                    conn, _ = srv.accept()
                except OSError:
                    break
                try:
                    while True:
                        req = _recv(conn)
                        if req is None:
                            break
                        if req.get("op") == "ping":
                            _send(conn, {"ok": True,
                                         "n_targets": self.n_targets,
                                         "launches": self.launches()})
                            continue
                        if req.get("op") == "shutdown":
                            _send(conn, {"ok": True})
                            running["on"] = False
                            break
                        try:
                            reply = {"scores": self.scan(
                                req["profile"], req.get("cap", 255),
                                req.get("mode", MODE_GAPLESS),
                                req.get("go", 11), req.get("ge", 1))}
                        except Exception as e:
                            # answered, not hidden: the client raises it
                            log.error(f"scan failed: {e!r}")
                            reply = {"error": repr(e)}
                        _send(conn, reply)
                except (ConnectionError, EOFError):
                    pass
                finally:
                    conn.close()
        finally:
            srv.close()
            if os.path.exists(path):
                os.unlink(path)
        return 0


def _connect(db_path, timeout):
    """A connection to the DB's server, or None when none is running (no
    socket, or one left behind by a server that is gone)."""
    path = socket_path_for(db_path)
    if not os.path.exists(path):
        return None
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout)
    try:
        conn.connect(path)
    except (ConnectionRefusedError, FileNotFoundError):
        conn.close()
        return None
    return conn


def query_server(db_path, profile, cap, mode, go=11, ge=1, timeout=600):
    """Client: scores (n_targets,) in DB order, or None if no server is
    running for this DB. A server that took the connection and then gives no
    valid answer (it died, timed out or reported an error) raises: the
    caller must not compute locally as if there had been none."""
    conn = _connect(db_path, timeout)
    if conn is None:
        return None
    try:
        _send(conn, {"op": "scan", "profile": np.asarray(profile),
                     "cap": int(cap), "mode": int(mode), "go": int(go),
                     "ge": int(ge)})
        resp = _recv(conn)
    except OSError as e:
        raise RuntimeError(f"the gpuserver for {db_path} failed a request: "
                           f"{e!r}") from e
    finally:
        conn.close()
    if not resp or "scores" not in resp:
        raise RuntimeError(f"the gpuserver for {db_path} failed a request: "
                           f"{resp.get('error') if resp else 'no reply'}")
    return resp["scores"]


def ping_server(db_path, timeout=60):
    """The server's ping reply ({"ok", "n_targets", ...}), or None if no
    server is running for this DB."""
    conn = _connect(db_path, timeout)
    if conn is None:
        return None
    try:
        _send(conn, {"op": "ping"})
        return _recv(conn)
    finally:
        conn.close()


def shutdown_server(db_path, timeout=60):
    """Ask the DB's server to stop; False if none is running."""
    conn = _connect(db_path, timeout)
    if conn is None:
        return False
    try:
        _send(conn, {"op": "shutdown"})
        _recv(conn)
        return True
    except OSError:
        return False
    finally:
        conn.close()


def server_submat(par, db_path):
    """The matrix a server encodes its DB with: the amino-acid one at bit
    factor 2, or for a nucleotide DB the nucleotide one at bit factor 1 (the
    JAX server's choice; the clients' profiles stay amino-acid ones, so a
    nucleotide DB scores otherwise through a server than locally)."""
    from ..commands.common import get_sub_mat
    from ..db.reader import DBReader

    base_type = DBReader(db_path).base_type
    if base_type not in (dbt.DBTYPE_AMINO_ACIDS, dbt.DBTYPE_NUCLEOTIDES):
        raise NotImplementedError(
            "gpuserver on a profile database is not yet ported (see "
            "ROADMAP.md)")
    nucl = base_type == dbt.DBTYPE_NUCLEOTIDES
    return get_sub_mat(par, nucl=nucl, bit_factor=1.0 if nucl else 2.0)


def gpuserver(par, command):
    db_path = par.filenames[0]
    return DeviceIndexServer(db_path, server_submat(par, db_path)).serve()
