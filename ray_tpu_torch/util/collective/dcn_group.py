"""Eager cross-process collectives over TCP rings (the DCN path; the port
of ray_tpu/util/collective/dcn_group.py).

Plays the role of the reference's GLOOGroup
(python/ray/util/collective/collective_group/gloo_collective_group.py,
pygloo with rendezvous through the GCS internal KV — gloo_util.py:271):
ring algorithms over persistent sockets between processes, for gradient
sync outside compiled programs and for control data.

Algorithms (selected per op from the alpha-beta cost model in
topology.py, overridable via RT_COLLECTIVE_ALGO; the choice is recorded
in `last_op_info` and flows to the flight-recorder op observers):
  * allreduce[ring]: ring reduce-scatter + ring allgather (bandwidth-
    optimal, 2*(n-1)/n * bytes per link); optionally quantized on the
    wire (quant="int8"/"fp8", see quant.py): codes are decoded and
    reduced in fp32 at every hop (ReduceOp-safe two-pass), with an
    optional error-feedback residual folded into the next call.
  * allreduce[rd]: recursive doubling — ceil(log2 n) rounds moving the
    full message; latency-optimal for small tensors. Non-power-of-2
    folds the extra ranks in and out.
  * allgather / reducescatter: single ring pass
  * broadcast: ring forward from root
  * barrier: a one-element allreduce
  * send/recv: direct socket between ranks

Tensors: every op takes a torch tensor on any device or a numpy array and
returns the same kind, on the same device. A card tensor is staged
through a pinned host buffer; reductions run on the host in torch, in the
tensor's own dtype and in the JAX package's chunk order, so each add
rounds once as numpy's does. A dtype crosses the wire as a tag (bfloat16
as "bf16" over its raw 2-byte view), so bf16 reduces as any dtype does.

Every payload byte that leaves this rank is counted (`bytes_sent`), and
the send path honors the chaos DCN injections (`chaos.delay_dcn_send`,
`chaos.cap_dcn_bandwidth`).

Every exchange in which a rank both sends and receives (a ring step, a
recursive-doubling round) sends a message above 16 KiB on a helper
thread while it receives: each member of a ring sends before it
receives, so with blocking sends a message larger than the sockets'
buffers would hold every member on its right neighbour at once. The JAX
package's ring does that, and deadlocks past the buffers (ROADMAP §C);
the order of the reductions is its.

Fault model: every socket carries an op deadline, so a dead, severed or
wedged peer raises a typed CollectiveTimeoutError instead of hanging the
surviving ranks, and rendezvous is stamped with a gang *epoch* — a stale
member from a torn-down attempt can neither find the new ring in the KV
nor pass the identification handshake. A link the peer closed mid-op
(its process died, or `chaos.sever_dcn_peer`) raises the same typed error
at once, where the JAX package lets a bare ConnectionError through.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from ray_tpu_torch._private import chaos
from ray_tpu_torch.exceptions import CollectiveTimeoutError
from ray_tpu_torch.util import journal
from ray_tpu_torch.util.collective import quant as quant_mod
from ray_tpu_torch.util.collective._tensors import (as_torch, dtype_name,
                                                     dtype_tag, from_bytes,
                                                     raw_bytes, tag_dtype,
                                                     to_host)
from ray_tpu_torch.util.collective.topology import (
    ALGO_HIER,
    ALGO_RD,
    ALGO_RING,
    Topology,
)
from ray_tpu_torch.util.collective.types import ReduceOp

logger = logging.getLogger("ray_tpu_torch.collective")

_LEN = struct.Struct("<Q")
# Identification frame on every initiated connection: sender rank + the
# gang epoch it believes it belongs to + the sender's HLC stamp
# (physical µs, logical counter) so the connect itself is causally
# ordered in the cluster journal.
_IDENT = struct.Struct("<IIQI")
# A message this small never blocks a send: Linux's TCP send buffer
# starts at 16 KiB (tcp_wmem) and a loopback peer's receive buffer holds
# several.
_INLINE_BYTES = 16 << 10


def _reduce(op: ReduceOp, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a op b, into `a` (a tensor the ring owns): one rounding per element,
    as numpy's a + b has."""
    if op == ReduceOp.SUM:
        return a.add_(b)
    if op == ReduceOp.PRODUCT:
        return a.mul_(b)
    if op == ReduceOp.MIN:
        return torch.minimum(a, b, out=a)
    if op == ReduceOp.MAX:
        return torch.maximum(a, b, out=a)
    raise ValueError(op)


class _Peer:
    def __init__(self, sock: socket.socket, op_timeout: Optional[float] = None,
                 on_send=None):
        self.sock = sock
        self.lock = threading.Lock()
        # Owning group's byte accountant: called with the framed length
        # of every send.
        self.on_send = on_send
        # One deadline per blocking socket op: a peer that stops draining
        # (or stops sending) trips socket.timeout instead of blocking the
        # rank forever mid-collective.
        if op_timeout and op_timeout > 0:
            sock.settimeout(op_timeout)

    def send_bytes(self, data):
        n = len(data)
        with self.lock:
            # Chaos DCN injections: a fixed per-send delay (link latency)
            # and a bandwidth cap (a saturated slow tier). Both are
            # no-cost reads when chaos is off.
            delay = chaos.take_dcn_send_delay()
            if delay:
                time.sleep(delay)
            cap = chaos.dcn_bandwidth_cap()
            if cap:
                time.sleep((n + _LEN.size) / cap)
            self.sock.sendall(_LEN.pack(n))
            if n:
                self.sock.sendall(data)
            if self.on_send is not None:
                self.on_send(n + _LEN.size)

    def recv_bytes(self) -> bytearray:
        (n,) = _LEN.unpack(self._recv_exact(_LEN.size))
        return self._recv_exact(n)

    def _recv_exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self.sock.recv_into(view[got:], min(n - got, 1 << 22))
            if not k:
                raise ConnectionError("collective peer closed")
            got += k
        return buf


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _send_array(peer: _Peer, t: torch.Tensor):
    header = f"{dtype_tag(t.dtype)}|{','.join(map(str, t.shape))}".encode()
    peer.send_bytes(header)
    peer.send_bytes(raw_bytes(t.contiguous()))


def _recv_array(peer: _Peer) -> torch.Tensor:
    out = _recv_frame(peer)
    if isinstance(out, quant_mod.QuantPayload):
        return quant_mod.decode(out)
    return out


def _send_quant(peer: _Peer, p: quant_mod.QuantPayload):
    """Quantized frame: 'Q|' header + codes + scales (3 length-prefixed
    messages; the byte accountant sees the true wire cost)."""
    shape_str = ",".join(map(str, p.shape))
    peer.send_bytes(
        f"Q|{p.scheme}|{p.block}|{p.dtype}|{shape_str}".encode()
    )
    peer.send_bytes(raw_bytes(p.codes.contiguous()))
    peer.send_bytes(raw_bytes(p.scales.contiguous()))


def _shape(shape_str: str) -> tuple:
    return tuple(int(s) for s in shape_str.split(",")) if shape_str else ()


def _recv_frame(peer: _Peer):
    """Receive one frame: a plain tensor or a QuantPayload (returned
    undecoded so the allgather phase can forward codes verbatim without
    re-quantizing)."""
    header = bytes(peer.recv_bytes()).decode()
    if header.startswith("Q|"):
        _, scheme, block, tag, shape_str = header.split("|")
        codes = peer.recv_bytes()
        scales = peer.recv_bytes()
        return quant_mod.QuantPayload(
            scheme=scheme, codes=from_bytes(codes, torch.int8, (len(codes),)),
            scales=from_bytes(scales, torch.float32, (len(scales) // 4,)),
            shape=_shape(shape_str), dtype=tag, block=int(block),
        )
    tag, shape_str = header.split("|")
    return from_bytes(peer.recv_bytes(), tag_dtype(tag), _shape(shape_str))


class DcnGroup:
    """One rank's membership in a TCP collective ring.

    `epoch` is the gang attempt number: a restarted training gang bumps
    it so rendezvous keys and identification frames from the previous
    (possibly half-dead) attempt can never splice into the new ring.
    `op_timeout` bounds every blocking send/recv inside a collective;
    exceeding it raises CollectiveTimeoutError.
    """

    def __init__(self, kv, world_size: int, rank: int, group_name: str,
                 timeout: Optional[float] = None, epoch: int = 0,
                 op_timeout: Optional[float] = None):
        from ray_tpu_torch._private.config import get_config

        cfg = get_config()
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.epoch = int(epoch)
        self._kv = kv
        # Flat topology as this ring sees it (each member is one DCN
        # endpoint); drives the per-op ring-vs-recursive-doubling choice.
        self.topo = Topology.detect(world_size, n_local=1)
        # Framed payload bytes this rank has pushed onto DCN (lifetime).
        self.bytes_sent = 0
        # (op, algo, tier, bytes, dtype, quant) of the last completed op
        # — read by the collective-API observer/metrics layer.
        self.last_op_info: dict = {}
        # Error-feedback residuals for quantized allreduce (lazy).
        self._ef: Optional[quant_mod.ErrorFeedback] = None
        self._timeout = (timeout if timeout is not None
                         else cfg.collective_rendezvous_timeout_s)
        self._op_timeout = (op_timeout if op_timeout is not None
                            else cfg.collective_op_timeout_s)
        # Listening socket for incoming peers.
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", 0))
        self._server.listen(world_size + 2)
        self.addr = self._server.getsockname()
        # Written by the accept thread, read by collective ops.
        self._accepted: Dict[int, _Peer] = {}
        self._accepted_lock = threading.Lock()
        self._outgoing: Dict[int, _Peer] = {}
        # Sends of an exchange run here while the caller receives.
        self._sender = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"dcn-send-{group_name}")
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        self._register()

    # -- rendezvous through the GCS KV ----------------------------------
    def _key(self, rank: int) -> bytes:
        # Epoch-stamped: a stale rank from attempt N-1 looks up keys that
        # the attempt-N gang never wrote, and times out at rendezvous.
        return f"collective:{self.group_name}:e{self.epoch}:{rank}".encode()

    def _register(self):
        self._kv.kv_put(
            self._key(self.rank),
            f"{self.addr[0]}:{self.addr[1]}".encode(),
            ns="collective",
        )

    def _lookup(self, rank: int) -> tuple:
        deadline = time.monotonic() + self._timeout
        while time.monotonic() < deadline:
            raw = self._kv.kv_get(self._key(rank), ns="collective")
            if raw:
                host, port = raw.decode().rsplit(":", 1)
                return host, int(port)
            time.sleep(0.02)
        raise TimeoutError(
            f"rendezvous timeout waiting for rank {rank} of group "
            f"{self.group_name!r} (epoch {self.epoch})"
        )

    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = _Peer(sock, self._op_timeout, on_send=self._count_sent)
            # First frame identifies the sender: (rank, epoch). A member
            # of a different epoch is a zombie from a torn-down attempt —
            # close the socket so it can never inject into this ring.
            try:
                rank, epoch, pt, lc = _IDENT.unpack(bytes(peer.recv_bytes()))
                if pt:
                    journal.observe_wire([pt, lc])
            except Exception:  # noqa: BLE001 — malformed handshake
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            if epoch != self.epoch:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            with self._accepted_lock:
                self._accepted[rank] = peer

    def _peer_out(self, rank: int) -> _Peer:
        """Connection this rank initiated (used for sends to `rank`)."""
        peer = self._outgoing.get(rank)
        if peer is None:
            host, port = self._lookup(rank)
            sock = socket.create_connection((host, port), timeout=self._timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = _Peer(sock, self._op_timeout, on_send=self._count_sent)
            pt, lc = journal.wire_stamp() or (0, 0)
            peer.send_bytes(_IDENT.pack(self.rank, self.epoch, pt, lc))
            self._outgoing[rank] = peer
        return peer

    def _peer_in(self, rank: int) -> _Peer:
        """Connection initiated by `rank` toward us (used for receives)."""
        deadline = time.monotonic() + self._timeout
        while time.monotonic() < deadline:
            with self._accepted_lock:
                peer = self._accepted.get(rank)
            if peer is not None:
                return peer
            time.sleep(0.002)
        raise CollectiveTimeoutError(
            f"no inbound connection from rank {rank} of group "
            f"{self.group_name!r} (epoch {self.epoch}) after "
            f"{self._timeout:.1f}s",
            group_name=self.group_name, rank=self.rank, peer_rank=rank,
        )

    def _timeout_error(self, op: str, peer_rank: int,
                       exc: Optional[BaseException] = None
                       ) -> CollectiveTimeoutError:
        closed = exc is not None and not isinstance(exc, socket.timeout)
        journal.emit("collective.timeout", op=op, group=self.group_name,
                     rank=self.rank, peer_rank=peer_rank,
                     epoch=self.epoch, timeout_s=self._op_timeout,
                     closed=closed)
        journal.trigger_postmortem(
            f"collective_timeout:{op}",
            group=self.group_name, rank=self.rank, peer_rank=peer_rank,
        )
        why = (f"lost its link to rank {peer_rank} ({exc!r})" if closed
               else f"timed out after {self._op_timeout:.1f}s waiting on "
                    f"rank {peer_rank}")
        return CollectiveTimeoutError(
            f"collective {op} in group {self.group_name!r} (rank "
            f"{self.rank}, epoch {self.epoch}) {why} — the peer is dead, "
            f"severed or wedged",
            group_name=self.group_name, rank=self.rank, peer_rank=peer_rank,
        )

    # -- collectives -----------------------------------------------------
    def _exchange(self, send, recv, inbound: _Peer, nbytes: int):
        """recv()'s value (it reads from `inbound`), with send() of
        `nbytes` run on the sender thread meanwhile. A send that fails
        shuts `inbound` down, so the op fails at once with the send's
        error rather than waiting out its deadline on a peer that may
        never send. A message that the socket buffers hold whole goes
        out first on this thread, as the JAX package sends: the hand-off
        to the sender thread costs more than such a message."""
        if nbytes <= _INLINE_BYTES:
            send()
            return recv()

        def on_done(fut):
            if fut.exception() is not None:
                try:
                    inbound.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

        pending = self._sender.submit(send)
        pending.add_done_callback(on_done)
        try:
            out = recv()
        except OSError:
            if pending.done() and pending.exception() is not None:
                raise pending.exception() from None
            raise
        pending.result()
        return out

    @property
    def _right(self) -> int:
        return (self.rank + 1) % self.world_size

    @property
    def _left(self) -> int:
        return (self.rank - 1) % self.world_size

    def _count_sent(self, nbytes: int) -> None:
        self.bytes_sent += nbytes

    def _record_op(self, op_name: str, algo: str, bytes0: int,
                   dtype, quant: Optional[str] = None) -> None:
        self.last_op_info = {
            "op": op_name,
            "algo": algo,
            "tier": "dcn",
            "bytes": self.bytes_sent - bytes0,
            "dtype": dtype_name(dtype),
            "quant": quant,
        }

    def allreduce(self, arr, op: ReduceOp = ReduceOp.SUM,
                  quant: Optional[str] = None, error_feedback: bool = False,
                  algo: Optional[str] = None,
                  ef_key: Optional[object] = None):
        """Allreduce with per-op algorithm selection.

        quant: "int8"/"fp8" — block-scale-quantize every wire message
            (ring only; codes are decoded and reduced in fp32 per hop).
        error_feedback: keep this rank's quantization residual and fold
            it into the next allreduce on the same `ef_key` (SUM only).
        algo: force "ring"/"rd"; default consults the topology cost
            model (and the RT_COLLECTIVE_ALGO env override).
        """
        t, back = as_torch(arr)
        n = self.world_size
        bytes0 = self.bytes_sent
        nbytes = t.numel() * t.element_size()
        if algo is None:
            algo = self.topo.select("allreduce", nbytes)
        if algo == ALGO_HIER:
            algo = ALGO_RING  # a flat ring has no local tier to shard on
        if quant is not None:
            quant_mod.validate_scheme(quant)
            algo = ALGO_RING  # quantization targets the bandwidth regime
        if error_feedback and not quant:
            raise ValueError("error_feedback requires quant='int8'/'fp8'")
        if error_feedback and op != ReduceOp.SUM:
            raise ValueError(
                "error_feedback folds an additive residual into the "
                "input — only ReduceOp.SUM is EF-safe"
            )
        if n == 1:
            self._record_op("allreduce", algo, bytes0, t.dtype, quant)
            return back(t.clone())
        host = to_host(t)
        # A staged copy is the ring's own to reduce into; the caller's
        # CPU tensor is not.
        if host is t:
            host = t.clone()
        if algo == ALGO_RD:
            out = self._allreduce_rd(host, op)
        else:
            out = self._allreduce_ring(host, op, quant=quant,
                                       error_feedback=error_feedback,
                                       ef_key=ef_key)
        self._record_op("allreduce", algo, bytes0, t.dtype, quant)
        return back(out)

    def _allreduce_ring(self, arr: torch.Tensor, op: ReduceOp,
                        quant: Optional[str] = None,
                        error_feedback: bool = False,
                        ef_key: Optional[object] = None) -> torch.Tensor:
        """Ring reduce-scatter + allgather on a host tensor it may reduce
        into; with `quant`, every hop's message is quantized on the wire
        but reduced in fp32 (the quantize-scatter / reduce-fp32 /
        quantize-gather two-pass), and with `error_feedback` the rounding
        error this rank injects is banked and folded into the next call's
        input."""
        n = self.world_size
        flat = arr.reshape(-1)
        ef = None
        if error_feedback:
            if self._ef is None:
                self._ef = quant_mod.ErrorFeedback()
            ef = self._ef
            if ef_key is None:
                ef_key = ("allreduce", flat.numel())
            flat = ef.apply(ef_key, flat)
        elif quant:
            flat = flat.to(torch.float32)
        chunks: List[torch.Tensor] = list(torch.tensor_split(flat, n))
        # Flat offset of each chunk (EF residuals are positional).
        offsets = [0]
        for c in chunks:
            offsets.append(offsets[-1] + c.numel())
        size = flat.numel()
        right, left = self._peer_out(self._right), self._peer_in(self._left)

        def _ship(idx: int):
            """Send chunk `idx`, quantizing (and EF-banking) if asked."""
            if not quant:
                _send_array(right, chunks[idx])
                return
            payload = quant_mod.encode(chunks[idx], quant)
            _send_quant(right, payload)
            if ef is not None:
                ef.add(ef_key, offsets[idx],
                       chunks[idx] - quant_mod.decode(payload).reshape(-1),
                       size)

        try:
            # Phase 1: ring reduce-scatter (reduction always on decoded
            # fp32/native values, never on codes).
            for step in range(n - 1):
                send_idx = (self.rank - step) % n
                recv_idx = (self.rank - step - 1) % n
                incoming = self._exchange(
                    lambda i=send_idx: _ship(i), lambda: _recv_array(left),
                    left, _nbytes(chunks[send_idx]))
                chunks[recv_idx] = _reduce(op, chunks[recv_idx],
                                           incoming.reshape(-1))
            # Phase 2: ring allgather of reduced chunks. Quantized mode
            # encodes each chunk ONCE (by its owner) and forwards the
            # received codes verbatim, so every rank decodes identical
            # values (bitwise-consistent results across the ring).
            prev_payload = None
            for step in range(n - 1):
                send_idx = (self.rank + 1 - step) % n
                recv_idx = (self.rank - step) % n
                if not quant:
                    out = chunks[send_idx]
                    chunks[recv_idx] = self._exchange(
                        lambda: _send_array(right, out),
                        lambda: _recv_array(left), left,
                        _nbytes(out)).reshape(-1)
                    continue
                if step == 0:  # own reduced chunk: quantize once
                    payload = quant_mod.encode(chunks[send_idx], quant)
                    decoded = quant_mod.decode(payload).reshape(-1)
                    if ef is not None:
                        ef.add(ef_key, offsets[send_idx],
                               chunks[send_idx] - decoded, size)
                    # Every rank must end with the same values: the
                    # owner keeps the decoded codes too.
                    chunks[send_idx] = decoded
                else:  # forward the received codes unchanged
                    payload = prev_payload
                prev_payload = self._exchange(
                    lambda p=payload: _send_quant(right, p),
                    lambda: _recv_frame(left), left, payload.wire_bytes)
                chunks[recv_idx] = (
                    quant_mod.decode(prev_payload).reshape(-1))
        except OSError as e:
            raise self._timeout_error("allreduce", self._left, e) from None
        return torch.cat(chunks).reshape(arr.shape).to(arr.dtype)

    def _allreduce_rd(self, arr: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        """Recursive doubling on a host tensor it may reduce into:
        ceil(log2 n) pairwise full-message exchanges — latency-optimal for
        small messages. Non-power-of-2 world sizes fold the surplus ranks
        into the low ranks first and fan the result back out at the end.
        Each pair sends both ways at once (_exchange)."""
        n = self.world_size
        r = self.rank
        p = 1 << (n.bit_length() - 1)  # largest power of two <= n
        val = arr.reshape(-1)
        shape, dtype = arr.shape, arr.dtype
        extra = n - p
        partner = r  # last peer touched, for the timeout message
        try:
            if r >= p:
                # Surplus rank: contribute to the partner, then wait for
                # the fanned-out result.
                partner = r - p
                _send_array(self._peer_out(partner), val)
                out = _recv_array(self._peer_in(partner)).reshape(-1)
                return out.reshape(shape).to(dtype)
            if r < extra:
                partner = r + p
                incoming = _recv_array(self._peer_in(r + p)).reshape(-1)
                val = _reduce(op, val, incoming)
            mask = 1
            while mask < p:
                partner = r ^ mask
                po, pi = self._peer_out(partner), self._peer_in(partner)
                incoming = self._exchange(
                    lambda v=val: _send_array(po, v),
                    lambda: _recv_array(pi), pi, _nbytes(val))
                val = _reduce(op, val, incoming.reshape(-1))
                mask <<= 1
            if r < extra:
                _send_array(self._peer_out(r + p), val)
        except OSError as e:
            raise self._timeout_error("allreduce[rd]", partner, e) from None
        return val.reshape(shape).to(dtype)

    def allgather(self, arr) -> list:
        t, back = as_torch(arr)
        n = self.world_size
        bytes0 = self.bytes_sent
        out: List[Optional[torch.Tensor]] = [None] * n
        out[self.rank] = to_host(t).clone()
        if n > 1:
            right, left = (self._peer_out(self._right),
                           self._peer_in(self._left))
            try:
                for step in range(n - 1):
                    send_idx = (self.rank - step) % n
                    recv_idx = (self.rank - step - 1) % n
                    t = out[send_idx]
                    out[recv_idx] = self._exchange(
                        lambda: _send_array(right, t),
                        lambda: _recv_array(left), left, _nbytes(t))
            except OSError as e:
                raise self._timeout_error("allgather", self._left,
                                          e) from None
        self._record_op("allgather", ALGO_RING, bytes0, t.dtype)
        return [back(o) for o in out]

    def reducescatter(self, arr, op: ReduceOp = ReduceOp.SUM):
        """Each rank gets the reduction of its 1/n slice.

        Ring reduce-scatter with the schedule shifted so that rank r ends
        holding fully-reduced chunk r.
        """
        t, back = as_torch(arr)
        n = self.world_size
        bytes0 = self.bytes_sent
        flat = to_host(t).reshape(-1)
        chunks = [c.clone() for c in torch.tensor_split(flat, n)]
        if n == 1:
            self._record_op("reducescatter", ALGO_RING, bytes0, t.dtype)
            return back(chunks[0])
        right, left = self._peer_out(self._right), self._peer_in(self._left)
        try:
            for step in range(n - 1):
                send_idx = (self.rank - step + n - 1) % n
                recv_idx = (self.rank - step + n - 2) % n
                t = chunks[send_idx]
                incoming = self._exchange(lambda: _send_array(right, t),
                                          lambda: _recv_array(left), left,
                                          _nbytes(t))
                chunks[recv_idx] = _reduce(op, chunks[recv_idx], incoming)
        except OSError as e:
            raise self._timeout_error("reducescatter", self._left,
                                      e) from None
        self._record_op("reducescatter", ALGO_RING, bytes0, t.dtype)
        return back(chunks[self.rank])

    def broadcast(self, arr, root: int = 0):
        t, back = as_torch(arr)
        bytes0 = self.bytes_sent
        if self.world_size == 1:
            self._record_op("broadcast", ALGO_RING, bytes0, t.dtype)
            return back(t.clone())
        out = to_host(t).clone() if self.rank == root else None
        try:
            # Forward around the ring, skipping the wrap back to root.
            if self.rank != root:
                out = _recv_array(self._peer_in(self._left))
            if self._right != root:
                _send_array(self._peer_out(self._right), out)
        except OSError as e:
            raise self._timeout_error("broadcast", self._left, e) from None
        self._record_op("broadcast", ALGO_RING, bytes0, out.dtype)
        return back(out)

    def reduce(self, arr, root: int = 0, op: ReduceOp = ReduceOp.SUM):
        # Simple: allreduce then root keeps (fine at control-plane sizes).
        t, back = as_torch(arr)
        bytes0 = self.bytes_sent
        out = self.allreduce(t, op)
        algo = self.last_op_info.get("algo", ALGO_RING)
        self._record_op("reduce", algo, bytes0, t.dtype)
        return back(out if self.rank == root else t.clone())

    def barrier(self):
        bytes0 = self.bytes_sent
        self.allreduce(torch.zeros(1, dtype=torch.int32))
        algo = self.last_op_info.get("algo", ALGO_RING)
        self._record_op("barrier", algo, bytes0, torch.int32)

    def send(self, arr, dst_rank: int):
        t, _ = as_torch(arr)
        bytes0 = self.bytes_sent
        try:
            _send_array(self._peer_out(dst_rank), to_host(t))
        except OSError as e:
            raise self._timeout_error("send", dst_rank, e) from None
        self._record_op("send", "p2p", bytes0, t.dtype)

    def recv(self, src_rank: int, like=None):
        """The tensor `src_rank` sent: in the kind and on the device of
        `like` where one is given, else a CPU torch tensor."""
        bytes0 = self.bytes_sent
        try:
            out = _recv_array(self._peer_in(src_rank))
        except OSError as e:
            raise self._timeout_error("recv", src_rank, e) from None
        self._record_op("recv", "p2p", bytes0, out.dtype)
        if like is None:
            return out
        _, back = as_torch(like)
        return back(out)

    def destroy(self):
        # Drop the rendezvous entry so a recreated group with the same name
        # never resolves to this (now dead) listener.
        try:
            self._kv.kv_del(self._key(self.rank), ns="collective")
        except Exception:  # noqa: BLE001
            # A stale entry only delays (never corrupts) a future group:
            # rendezvous keys are epoch-stamped, so leaking one is safe —
            # but record it, a flood of these means the GCS is sick.
            logger.warning(
                "failed to delete rendezvous key for rank %d of group "
                "%r (epoch %d)", self.rank, self.group_name, self.epoch,
                exc_info=True,
            )
        try:
            self._server.close()
        except OSError:
            pass
        self._sender.shutdown(wait=False)
        with self._accepted_lock:
            accepted = list(self._accepted.values())
        for p in accepted + list(self._outgoing.values()):
            try:
                p.sock.close()
            except OSError:
                pass
