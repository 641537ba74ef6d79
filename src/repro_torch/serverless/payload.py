"""Request/response payload codec + byte budgets (paper §3.3 payload flow).

Every hop in the invocation tree exchanges *encoded* payloads: a JSON header
(scalars, predicate lists, array manifest) followed by raw C-contiguous
array buffers. Encoding is what gives the runtime honest byte accounting —
the 6 MB synchronous-invocation cap AWS Lambda enforces is applied to the
encoded size, with an explicit overflow policy:

* ``"error"`` — raise :class:`PayloadOverflowError` (the deploy-time guard).
* ``"chunk"`` — split the request on its query axis into multiple
  invocations of the same function (each chunk pays its own invocation
  overhead and payload transfer; responses merge by global query index).
  An oversized *response* paginates instead: :func:`response_chunks` tells
  the runtime how many pages to bill as warm round-trips.

A payload that cannot be split further (a single query) always raises.

The port of the JAX package's ``repro.serverless.payload``: the same codec,
byte for byte. The length-prefixed frame protocol of the reference's socket
transport comes with the socket transport, which is not ported yet.
"""

from __future__ import annotations

import json
import struct
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.attributes import Predicate

__all__ = [
    "MAX_SYNC_PAYLOAD_BYTES", "OVERFLOW_POLICIES", "PayloadOverflowError",
    "encode_message", "decode_message", "chunk_request", "response_chunks",
    "predicates_to_json", "predicates_from_json",
    "OBS_EXTRA_KEY", "inject_span_context", "extract_span_context",
]

# AWS Lambda request/response limit for synchronous invocations (6 MB).
MAX_SYNC_PAYLOAD_BYTES = 6 * 1024 * 1024

OVERFLOW_POLICIES = ("error", "chunk")

_MAGIC = b"SQP1"


class PayloadOverflowError(RuntimeError):
    """A payload exceeded the per-invocation byte budget and could not be
    (or was configured not to be) chunked."""


def encode_message(msg: Dict) -> bytes:
    """Serialize a flat dict of numpy arrays + JSON-able scalars."""
    arrays: List[Tuple[str, np.ndarray]] = []
    meta: Dict = {}
    for key, val in msg.items():
        if isinstance(val, np.ndarray):
            arrays.append((key, np.ascontiguousarray(val)))
        elif isinstance(val, (np.integer, np.floating)):
            meta[key] = val.item()
        else:
            meta[key] = val
    header = {
        "meta": meta,
        "arrays": [
            {"name": k, "dtype": a.dtype.str, "shape": list(a.shape)}
            for k, a in arrays
        ],
    }
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    out = [_MAGIC, struct.pack("<I", len(hb)), hb]
    out.extend(a.tobytes() for _, a in arrays)
    return b"".join(out)


def decode_message(buf: bytes) -> Dict:
    """Inverse of :func:`encode_message` (arrays come back bit-identical)."""
    if buf[:4] != _MAGIC:
        raise ValueError("not a SQUASH payload (bad magic)")
    (hlen,) = struct.unpack("<I", buf[4:8])
    header = json.loads(buf[8 : 8 + hlen].decode("utf-8"))
    msg: Dict = dict(header["meta"])
    off = 8 + hlen
    for spec in header["arrays"]:
        dt = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        msg[spec["name"]] = np.frombuffer(
            buf[off : off + nbytes], dtype=dt
        ).reshape(shape).copy()
        off += nbytes
    return msg


def chunk_request(
    req: Dict,
    *,
    max_bytes: int,
    policy: str,
    split: Callable[[Dict, int, int], Dict],
    num_items: Callable[[Dict], int],
    fallback_split: Callable[[Dict, int, int], Dict] = None,
    fallback_num: Callable[[Dict], int] = None,
) -> List[Tuple[Dict, bytes]]:
    """Encode ``req``; on overflow apply the policy.

    ``split(req, lo, hi)`` must return the sub-request covering item
    positions [lo, hi) of the splittable axis (queries); ``num_items`` its
    length. When a *single-item* request still overflows and a fallback axis
    is provided (``fallback_split``/``fallback_num`` — the QP requests'
    candidate-row axis inside one partition), chunking recurses along it
    instead of erroring; a request indivisible on every axis always raises.
    Returns [(request, encoded_bytes), ...] — one entry per invocation the
    caller must issue.
    """
    if policy not in OVERFLOW_POLICIES:
        raise ValueError(f"unknown overflow policy {policy!r}; "
                         f"expected {OVERFLOW_POLICIES}")
    out: List[Tuple[Dict, bytes]] = []

    def rec(r: Dict) -> None:
        buf = encode_message(r)
        if len(buf) <= max_bytes:
            out.append((r, buf))
            return
        n = num_items(r)
        if policy != "error" and n > 1:
            rec(split(r, 0, n // 2))
            rec(split(r, n // 2, n))
            return
        if policy != "error" and fallback_split is not None:
            m = fallback_num(r)
            if m > 1:
                rec(fallback_split(r, 0, m // 2))
                rec(fallback_split(r, m // 2, m))
                return
        raise PayloadOverflowError(
            f"request payload of {len(buf)} B exceeds the "
            f"{max_bytes} B budget"
            + ("" if policy == "chunk"
               else " (overflow policy 'error')")
            + (" and cannot be split further"
               if policy == "chunk" and n <= 1 else "")
        )

    rec(req)
    return out


def response_chunks(nbytes: int, *, max_bytes: int, policy: str) -> int:
    """Number of response payloads needed; raises under the error policy."""
    if nbytes <= max_bytes:
        return 1
    if policy == "error":
        raise PayloadOverflowError(
            f"response payload of {nbytes} B exceeds the {max_bytes} B budget "
            "(overflow policy 'error')")
    return -(-nbytes // max_bytes)


# ------------------------------------------------------- span-context envelope

# Key under which a distributed-trace span context rides the invocation's
# ``extra`` envelope. The context travels *outside* the budgeted payload —
# pickled with ``extra`` over process pipes — so request-byte
# accounting and the 6 MB budget are bitwise-identical with tracing on or
# off. The value is a plain ``{"run": ..., "span": ...}`` dict
# (``repro_torch.obs.spans.SpanContext.to_wire``); this module stays
# dependency-free by not importing the obs layer.
OBS_EXTRA_KEY = "obs"


def inject_span_context(extra: Dict, ctx: Dict) -> Dict:
    """Attach a span context to an invocation's ``extra`` envelope.

    Mutates and returns ``extra``. A falsy ``ctx`` (tracing disabled) leaves
    the envelope untouched, so disabled runs serialize identical bytes.
    """
    if ctx:
        extra[OBS_EXTRA_KEY] = dict(ctx)
    return extra


def extract_span_context(extra) -> Dict:
    """The span context carried by ``extra``, or None (worker side)."""
    if not extra:
        return None
    ctx = extra.get(OBS_EXTRA_KEY)
    return dict(ctx) if ctx else None


def predicates_to_json(predicates: Sequence[Predicate]) -> List[Dict]:
    return [
        {"attr": int(p.attr), "op": p.op, "lo": float(p.lo),
         "hi": float(p.hi), "values": [float(v) for v in p.values],
         "group": p.group}
        for p in predicates
    ]


def predicates_from_json(items: Sequence[Dict]) -> List[Predicate]:
    return [
        Predicate(attr=int(d["attr"]), op=d["op"], lo=d["lo"], hi=d["hi"],
                  values=tuple(d["values"]), group=d["group"])
        for d in items
    ]
