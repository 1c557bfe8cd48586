"""Per-step manifests: the crash-consistency unit of the repository.

A step is *committed* iff its manifest exists in the catalog. The manifest
is computed from the fully-persisted step directory (file list, sizes,
per-file integrity checksums through the checksum kernel in
``repro_torch.kernels``) and written atomically *last*, so a crash at any
earlier point leaves an invisible (orphaned) step instead of a
restorable-looking half checkpoint.

Checksums walk the file in fixed 4 MiB chunks, digest each chunk, and fold
the chunk digests order-sensitively as ``sum((i+1) * digest_i) mod 2^32``,
so block reorder or truncation within *and* across chunks is caught. The
algorithm tag and the fold are the JAX package's, so either package
verifies the other's steps. On a card the file goes up in 64 MiB pieces,
each digested chunk by chunk in one launch.

Multi-rank saves add a second manifest layer — the *two-phase commit*.
Each writer rank persists its shard files, then writes a per-rank
:class:`RankManifest` (``rankNNNNN.manifest.json``, atomic tmp+rename):
the rank's phase-1 "prepared" vote, listing its files with sizes and
checksums computed on the rank's own lane. Each node's aggregator then
writes a :class:`NodeManifest` (``nodeNNNNN.manifest.json``) over its
members' votes. Only after every rank has voted does the coordinator
commit the global :class:`StepManifest` — phase 2 — and
:meth:`StepManifest.build` with ``expect_ranks=N`` cross-checks the votes
first: all expected rank manifests present, every declared file on disk
at its declared size, no undeclared shard files, and (with ``nodes``)
every node manifest covering exactly its members' votes. A crash or
straggler at any earlier point leaves a step with data files (and
possibly some votes) but no global manifest — invisible to
``latest_step`` and restore, exactly like a single-writer crash victim.
Per-rank checksums are reused by the global manifest, so the commit path
never recomputes what the rank lanes already hashed in parallel.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import os
import re
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_VERSION = 1
RANK_MANIFEST_VERSION = 1
NODE_MANIFEST_VERSION = 1
CHECKSUM_CHUNK_BYTES = 4 << 20
CHECKSUM_ALGO = "pallas-weighted-u32-chunk4m-v1"

# Filenames that belong to the repository, not the checkpoint payload.
_CONTROL_SUFFIXES = (".tmp",)
_RANK_MANIFEST_RE = re.compile(r"^rank(\d+)\.manifest\.json$")
_NODE_MANIFEST_RE = re.compile(r"^node(\d+)\.manifest\.json$")


class ManifestError(ValueError):
    """A manifest failed to build or validate (e.g. incomplete phase-1
    votes of a multi-rank save) — the step must not be committed."""


#: chunks in one piece of :func:`file_checksum`: one upload, one launch
#: and one read-back of 16 digests a 64 MiB piece at the default chunk
PIECE_CHUNKS = 16


def _read_full(f, view: memoryview) -> int:
    n = 0
    while n < len(view):
        got = f.readinto(view[n:])
        if not got:
            break
        n += got
    return n


class _Piece:
    """One of :func:`file_checksum`'s two buffers: the piece's bytes on
    the host (pinned on a card, from PyTorch's caching host allocator), its
    copy on the device, and its chunk digests. On a card an event recorded
    after the digests' read-back guards the buffer: :meth:`fold` waits on
    it before the buffer is refilled."""

    def __init__(self, nbytes: int, n_chunks: int, device: torch.device):
        self.on_card = device.type == "cuda"
        self.host = torch.empty(nbytes, dtype=torch.uint8,
                                pin_memory=self.on_card)
        self.view = memoryview(self.host.numpy())
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device) \
            if self.on_card else self.host
        self.dig = torch.empty(n_chunks, dtype=torch.int32, device=device)
        self.dig_host = torch.empty(n_chunks, dtype=torch.int32,
                                    pin_memory=True) \
            if self.on_card else self.dig
        self.done = torch.cuda.Event() if self.on_card else None
        self.first = self.count = 0

    def digest(self, n: int, first: int, chunk_bytes: int) -> None:
        """Enqueue the digests of the ``n`` bytes read into the buffer,
        chunks ``first`` on: the 0-3 bytes after a byte tail zeroed, then
        upload, one launch and the digests' read-back."""
        from repro_torch.kernels import ops

        padded = n + (-n) % 4
        self.host[n:padded] = 0
        words = self.dev[:padded]
        if self.on_card:
            words.copy_(self.host[:padded], non_blocking=True)
        self.first, self.count = first, -(-n // chunk_bytes)
        dig = ops.checksum_segments(words.view(torch.int32),
                                    chunk_bytes // 4,
                                    out=self.dig[:self.count])
        if self.on_card:
            self.dig_host[:self.count].copy_(dig, non_blocking=True)
            self.done.record()

    def fold(self) -> int:
        """``sum((i + 1) * digest_i)`` over the chunks the buffer holds
        (0 if none), once their digests are on the host."""
        if not self.count:
            return 0
        if self.done is not None:
            self.done.synchronize()
        digests = self.dig_host[:self.count].numpy().view(np.uint32)
        total = sum((self.first + j + 1) * int(d)
                    for j, d in enumerate(digests))
        self.count = 0
        return total


def file_checksum(path: str, device: torch.device,
                  chunk_bytes: int = CHECKSUM_CHUNK_BYTES) -> int:
    """Position-weighted u32 checksum of a file's bytes, chunk digests
    computed on ``device`` (the checksum kernel on a card, its plain
    version on the CPU).

    The file is read in pieces of :data:`PIECE_CHUNKS` chunks into two
    buffers in turn; on a card each piece goes up with one asynchronous
    copy and one launch digests its chunks, while the next piece is read
    from disk into the other buffer. The buffers belong to the call, so
    concurrent calls (the restoring thread and the commit lane) share
    none. ``chunk_bytes`` is a multiple of 16, so every chunk starts at a
    16-byte aligned word.

    The JAX package zero-pads the tail chunk to ``chunk_bytes``; zero words
    add nothing to a digest, so the tail is digested as read. The file
    length is recorded separately in the manifest, so zero padding is not a
    blind spot."""
    if chunk_bytes <= 0 or chunk_bytes % 16:
        raise ValueError(f"chunk_bytes must be a positive multiple of 16, "
                         f"got {chunk_bytes}")
    device = torch.device(device)
    total = 0
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        n_chunks = max(1, min(PIECE_CHUNKS, -(-size // chunk_bytes)))
        piece = n_chunks * chunk_bytes
        pieces = [_Piece(piece, n_chunks, device)
                  for _ in range(2 if size > piece else 1)]
        chunk = 0
        for buf in itertools.cycle(pieces):
            total += buf.fold()
            n = _read_full(f, buf.view)
            if not n:
                break
            buf.digest(n, chunk, chunk_bytes)
            chunk += -(-n // chunk_bytes)
        for buf in pieces:
            total += buf.fold()
    return total % (1 << 32)


@dataclasses.dataclass(frozen=True)
class FileEntry:
    """One checkpoint file inside a step.

    ``codec`` records how the file's tensor payload is encoded: ``"raw"``
    for full snapshots/keyframes, ``"xor+zstd"`` for delta files. ``None``
    for non-tensor files. ``domains`` records which state domains the file
    carries and how each was routed (``{"model": {"providers":
    ["tensor"], "codecs": ["raw"]}, ...}``)."""

    name: str
    nbytes: int
    checksum: Optional[int] = None
    codec: Optional[str] = None
    domains: Optional[Dict[str, Any]] = None


def dsllm_file_meta(path: str) -> Optional[Dict[str, Any]]:
    """Footer ``meta`` dict of one ``.dsllm`` file. ``None`` when
    unreadable."""
    try:
        from repro_torch.core.layout import FileReader
        return FileReader(path).meta or {}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def dsllm_file_codec(path: str) -> Optional[str]:
    """Tensor codec of one ``.dsllm`` file, from its footer meta."""
    meta = dsllm_file_meta(path)
    d = (meta or {}).get("delta") or {}
    if not d:
        return None
    return "raw" if d.get("keyframe", True) else d.get("codec", "raw")


def _write_vote(sdir: str, name: str, data: bytes) -> str:
    """Atomic write (tmp + rename): a vote either exists complete or not
    at all — a crash mid-write never leaves a parseable vote."""
    from repro_torch.core.layout import maybe_fsync
    from repro_torch.storage.backend import atomic_write
    path = os.path.join(sdir, name)
    atomic_write(path, data, fsync=maybe_fsync)
    return path


def rank_manifest_name(rank: int) -> str:
    return f"rank{rank:05d}.manifest.json"


@dataclasses.dataclass
class RankManifest:
    """One writer rank's phase-1 vote: "my shard files are durable".

    Written atomically by the rank itself after its engine reports
    persistence, *before* the rank acks the coordinator. Lists the rank's
    files with sizes and checksums — computed on the rank's lane, in
    parallel with the other ranks, so the global commit can reuse them
    instead of re-hashing the whole step serially.
    """

    rank: int
    world: int
    step: int
    files: List[FileEntry]
    checksum_algo: Optional[str] = None
    created_unix: float = 0.0
    version: int = RANK_MANIFEST_VERSION

    def to_json_bytes(self) -> bytes:
        d = dataclasses.asdict(self)
        d["files"] = [dataclasses.asdict(f) for f in self.files]
        return json.dumps(d, indent=1, sort_keys=True).encode()

    @classmethod
    def from_json_bytes(cls, data: bytes) -> "RankManifest":
        d = json.loads(data.decode())
        files = [FileEntry(**f) for f in d.pop("files", [])]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(files=files, **{k: v for k, v in d.items() if k in known})

    @classmethod
    def build(cls, sdir: str, *, rank: int, world: int, step: int,
              filenames: List[str], device: torch.device,
              checksum: bool = True,
              precomputed: Optional[Dict[str, int]] = None
              ) -> "RankManifest":
        """``precomputed`` maps basenames to checksums the rank's writers
        streamed while persisting — bit-identical to ``file_checksum`` by
        construction, so the vote reuses them instead of re-reading its
        own shard files; any other file is hashed on ``device``."""
        files = []
        pre = precomputed or {}
        for n in sorted(filenames):
            path = os.path.join(sdir, n)
            if not checksum:
                csum = None
            elif n in pre:
                csum = int(pre[n])
            else:
                csum = file_checksum(path, device)
            files.append(FileEntry(
                name=n, nbytes=os.path.getsize(path), checksum=csum))
        return cls(rank=rank, world=world, step=step, files=files,
                   checksum_algo=CHECKSUM_ALGO if checksum else None,
                   created_unix=time.time())

    def write(self, sdir: str) -> str:
        return _write_vote(sdir, rank_manifest_name(self.rank),
                           self.to_json_bytes())


def read_rank_manifests(sdir: str) -> Dict[int, RankManifest]:
    """All parseable phase-1 votes in a step directory, keyed by rank."""
    out: Dict[int, RankManifest] = {}
    for n in sorted(os.listdir(sdir)):
        if not _RANK_MANIFEST_RE.match(n):
            continue
        try:
            with open(os.path.join(sdir, n), "rb") as f:
                rm = RankManifest.from_json_bytes(f.read())
        except (OSError, ValueError) as exc:
            raise ManifestError(f"unreadable rank manifest {n!r}: {exc}") \
                from exc
        out[rm.rank] = rm
    return out


def node_manifest_name(node: int) -> str:
    return f"node{node:05d}.manifest.json"


@dataclasses.dataclass
class NodeManifest:
    """One node-local aggregator's vote in the hierarchical commit tree.

    Written atomically by the node's aggregator (its lowest writer rank)
    only after *every* member rank of the node has cast its own phase-1
    :class:`RankManifest` vote — the node barrier completed. ``votes``
    lists the member rank-manifest files themselves (sizes + checksums),
    so the global committer can audit "this whole subtree prepared"
    against n_nodes small files: barrier fan-in and commit validation
    both scale with the nodes, not the ranks. A node with a dead or
    stalled member never writes its manifest — the missing
    ``nodeNNNNN.manifest.json`` names the failed subtree.
    """

    node: int
    step: int
    world: int
    ranks: List[int]
    votes: List[FileEntry]
    checksum_algo: Optional[str] = None
    created_unix: float = 0.0
    version: int = NODE_MANIFEST_VERSION

    def to_json_bytes(self) -> bytes:
        d = dataclasses.asdict(self)
        d["votes"] = [dataclasses.asdict(v) for v in self.votes]
        return json.dumps(d, indent=1, sort_keys=True).encode()

    @classmethod
    def from_json_bytes(cls, data: bytes) -> "NodeManifest":
        d = json.loads(data.decode())
        votes = [FileEntry(**v) for v in d.pop("votes", [])]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(votes=votes, **{k: v for k, v in d.items() if k in known})

    @classmethod
    def build(cls, sdir: str, *, node: int, ranks: List[int], step: int,
              world: int, device: torch.device,
              checksum: bool = True) -> "NodeManifest":
        votes = []
        for r in sorted(ranks):
            path = os.path.join(sdir, rank_manifest_name(r))
            if not os.path.isfile(path):
                raise ManifestError(
                    f"step {step}: node {node} aggregating before rank "
                    f"{r} voted — {rank_manifest_name(r)!r} missing")
            votes.append(FileEntry(
                name=rank_manifest_name(r), nbytes=os.path.getsize(path),
                checksum=file_checksum(path, device) if checksum else None))
        return cls(node=node, step=step, world=world,
                   ranks=sorted(ranks), votes=votes,
                   checksum_algo=CHECKSUM_ALGO if checksum else None,
                   created_unix=time.time())

    def write(self, sdir: str) -> str:
        return _write_vote(sdir, node_manifest_name(self.node),
                           self.to_json_bytes())


def read_node_manifests(sdir: str) -> Dict[int, NodeManifest]:
    """All parseable node-aggregator votes in a step dir, keyed by node."""
    out: Dict[int, NodeManifest] = {}
    for n in sorted(os.listdir(sdir)):
        if not _NODE_MANIFEST_RE.match(n):
            continue
        try:
            with open(os.path.join(sdir, n), "rb") as f:
                nm = NodeManifest.from_json_bytes(f.read())
        except (OSError, ValueError) as exc:
            raise ManifestError(f"unreadable node manifest {n!r}: {exc}") \
                from exc
        out[nm.node] = nm
    return out


def _validate_node_votes(sdir: str, step: int, world: int,
                         nodes: Dict[int, Any], *, device: torch.device,
                         checksum: bool = True) -> None:
    """Audit the hierarchical commit tree's node-aggregator layer: every
    node with writers wrote its manifest, covering exactly its member
    ranks' votes at the recorded sizes (and checksums when enabled). A
    failed subtree never writes its node manifest, so the missing/extra
    set names exactly which aggregator's collective broke."""
    expect = {int(nid): sorted(int(r) for r in ranks)
              for nid, ranks in nodes.items() if ranks}
    nms = read_node_manifests(sdir)
    missing = sorted(set(expect) - set(nms))
    if missing:
        raise ManifestError(
            f"step {step}: node manifests missing for nodes {missing} — "
            f"those aggregator subtrees never completed; refusing to "
            f"commit")
    extra = sorted(set(nms) - set(expect))
    if extra:
        raise ManifestError(
            f"step {step}: unexpected node manifests {extra} (expected "
            f"nodes {sorted(expect)}) — a foreign aggregator voted")
    for nid, nranks in expect.items():
        nm = nms[nid]
        if sorted(nm.ranks) != nranks or nm.world != world \
                or nm.step != step:
            raise ManifestError(
                f"step {step}: node manifest {nid} covers ranks "
                f"{sorted(nm.ranks)} (world {nm.world}, step {nm.step}); "
                f"coordinator expects ranks {nranks} of world {world}")
        for ve in nm.votes:
            path = os.path.join(sdir, ve.name)
            if not os.path.isfile(path) \
                    or os.path.getsize(path) != ve.nbytes:
                raise ManifestError(
                    f"step {step}: node {nid} recorded vote {ve.name!r} "
                    f"at {ve.nbytes} B but the file is missing or "
                    f"resized — a vote changed after aggregation")
            if checksum and ve.checksum is not None \
                    and file_checksum(path, device) != ve.checksum:
                raise ManifestError(
                    f"step {step}: vote {ve.name!r} checksum mismatch "
                    f"vs node {nid}'s aggregation — a vote was "
                    f"rewritten after the node collective")


@dataclasses.dataclass
class StepManifest:
    """Everything the catalog knows about one committed step."""

    step: int
    files: List[FileEntry]
    format: str = "unknown"            # dsllm | snapshot | sync | unknown
    engine_mode: Optional[str] = None
    checksum_algo: Optional[str] = None
    created_unix: float = 0.0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    version: int = MANIFEST_VERSION

    @property
    def total_bytes(self) -> int:
        return sum(f.nbytes for f in self.files)

    def file(self, name: str) -> Optional[FileEntry]:
        for f in self.files:
            if f.name == name:
                return f
        return None

    def to_json_bytes(self) -> bytes:
        d = dataclasses.asdict(self)
        d["files"] = [dataclasses.asdict(f) for f in self.files]
        return json.dumps(d, indent=1, sort_keys=True).encode()

    @classmethod
    def from_json_bytes(cls, data: bytes) -> "StepManifest":
        d = json.loads(data.decode())
        files = [FileEntry(**f) for f in d.pop("files", [])]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(files=files, **{k: v for k, v in d.items() if k in known})

    @classmethod
    def build(cls, sdir: str, step: int, *, device: torch.device,
              engine_mode: Optional[str] = None, checksum: bool = True,
              meta: Optional[Dict[str, Any]] = None,
              expect_ranks: Optional[int] = None,
              writers: Optional[Any] = None,
              nodes: Optional[Dict[int, Any]] = None) -> "StepManifest":
        """Scan a fully-persisted step directory into a manifest.

        ``meta["file_checksums"]`` (checksums the writers streamed while
        persisting) and ``meta["file_domains"]`` (per-file routing known
        since plan time) are popped and land on the :class:`FileEntry`\\ s;
        a file without a streamed checksum is hashed on ``device``.

        With ``expect_ranks=N`` (a multi-rank save), the phase-1 votes are
        validated first: a rank manifest must be present for exactly the
        expected writer set (``writers`` — defaults to all N ranks; a
        coordinator that reassigned a dead rank's shard slice passes the
        surviving subset) and claim ``world == N``, every file a vote
        declares must be on disk at the declared size, and no undeclared
        shard file may exist. With ``nodes`` (``{node_id: [writer
        ranks]}``, the hierarchical commit tree), the node-aggregator
        votes are audited too. Any violation raises :class:`ManifestError`
        — the commit fails and the step stays an invisible orphan.
        Checksums declared by the votes are reused."""
        names = sorted(
            n for n in os.listdir(sdir)
            if os.path.isfile(os.path.join(sdir, n))
            and not any(s in n for s in _CONTROL_SUFFIXES))
        meta = dict(meta or {})
        file_domains: Dict[str, Any] = meta.pop("file_domains", None) or {}
        file_checksums: Dict[str, int] = \
            meta.pop("file_checksums", None) or {}
        declared: Dict[str, FileEntry] = {}
        if expect_ranks is not None:
            declared = _validate_rank_votes(sdir, step, names, expect_ranks,
                                            writers)
            if nodes is not None:
                _validate_node_votes(sdir, step, expect_ranks, nodes,
                                     device=device, checksum=checksum)
        probe_codec = meta.get("delta") is not None
        probe_domains = meta.get("domains") is not None
        files = []
        for n in names:
            path = os.path.join(sdir, n)
            fe_vote = declared.get(n)
            if checksum and fe_vote is not None \
                    and fe_vote.checksum is not None:
                csum: Optional[int] = fe_vote.checksum  # the rank's hash
            elif checksum and n in file_checksums:
                csum = int(file_checksums[n])
            elif checksum:
                csum = file_checksum(path, device)
            else:
                csum = None
            fe = FileEntry(name=n, nbytes=os.path.getsize(path),
                           checksum=csum, domains=file_domains.get(n))
            if (probe_codec or (probe_domains and fe.domains is None)) \
                    and n.endswith(".dsllm"):
                fmeta = dsllm_file_meta(path) or {}
                repl: Dict[str, Any] = {}
                d = fmeta.get("delta") or {}
                if probe_codec and d:
                    repl["codec"] = "raw" if d.get("keyframe", True) \
                        else d.get("codec", "raw")
                if probe_domains and fe.domains is None \
                        and fmeta.get("domains"):
                    repl["domains"] = fmeta["domains"]
                if repl:
                    fe = dataclasses.replace(fe, **repl)
            files.append(fe)
        if expect_ranks is not None:
            meta.setdefault("world", expect_ranks)
            if writers is not None and \
                    sorted(int(w) for w in writers) != \
                    list(range(expect_ranks)):
                # a partial writer set (dead ranks reassigned) is worth
                # recording: tooling can see which saves ran degraded
                meta.setdefault("writers", sorted(int(w) for w in writers))
            if nodes is not None:
                meta.setdefault("nodes", {
                    str(nid): sorted(int(r) for r in ranks)
                    for nid, ranks in nodes.items()})
        return cls(step=step, files=files, format=detect_format(names),
                   engine_mode=engine_mode,
                   checksum_algo=CHECKSUM_ALGO if checksum else None,
                   created_unix=time.time(), meta=meta)


def _validate_rank_votes(sdir: str, step: int, names: List[str],
                         expect_ranks: int, writers: Optional[Any]
                         ) -> Dict[str, FileEntry]:
    """The phase-1 gate of :meth:`StepManifest.build`: every expected
    writer voted, no other rank did, each vote's files are on disk at
    their declared sizes and declared once, and no file of the step goes
    undeclared. Returns the declared entries by file name."""
    writer_set = set(range(expect_ranks)) if writers is None \
        else {int(w) for w in writers}
    votes = read_rank_manifests(sdir)
    missing = sorted(writer_set - set(votes))
    if missing:
        raise ManifestError(
            f"step {step}: rank manifests missing for ranks {missing} of "
            f"writers {sorted(writer_set)} — not every writer prepared; "
            f"refusing to commit")
    foreign = sorted(set(votes) - writer_set)
    if foreign:
        raise ManifestError(
            f"step {step}: rank manifests from unexpected ranks {foreign} "
            f"(writers: {sorted(writer_set)}) — a foreign or "
            f"supposedly-dead writer voted; refusing to commit")
    declared: Dict[str, FileEntry] = {}
    for rank, rm in votes.items():
        if rm.world != expect_ranks:
            raise ManifestError(
                f"step {step}: rank manifest {rank} claims world "
                f"{rm.world}, coordinator expects {expect_ranks}")
        for fe in rm.files:
            path = os.path.join(sdir, fe.name)
            if not os.path.isfile(path):
                raise ManifestError(
                    f"step {step}: rank {rank} declared {fe.name!r} but "
                    f"it is not on disk")
            if os.path.getsize(path) != fe.nbytes:
                raise ManifestError(
                    f"step {step}: {fe.name!r} is {os.path.getsize(path)} "
                    f"B on disk, rank {rank} declared {fe.nbytes} B")
            if fe.name in declared:
                raise ManifestError(
                    f"step {step}: {fe.name!r} declared by two ranks — "
                    f"writer assignment broke the dedup invariant")
            declared[fe.name] = fe
    undeclared = [n for n in names
                  if n not in declared
                  and not _RANK_MANIFEST_RE.match(n)
                  and not _NODE_MANIFEST_RE.match(n)]
    if undeclared:
        raise ManifestError(
            f"step {step}: files {undeclared} present but not declared by "
            f"any rank manifest — stale shards or a foreign writer; "
            f"refusing to bless them")
    return declared


def detect_format(names) -> str:
    names = list(names)
    if any(n.endswith(".dsllm") for n in names):
        return "dsllm"
    if any(n.startswith("manifest_rank") and n.endswith(".pkl")
           for n in names):
        return "snapshot"
    if any(n.endswith(".pkl") for n in names):
        return "sync"
    return "unknown"


_TRAILER = struct.Struct("<Q8s")


def _dsllm_trailer_ok(path: str) -> bool:
    from repro_torch.core.layout import MAGIC
    try:
        size = os.path.getsize(path)
        if size < _TRAILER.size:
            return False
        with open(path, "rb") as f:
            f.seek(size - _TRAILER.size)
            footer_len, magic = _TRAILER.unpack(f.read(_TRAILER.size))
        return magic == MAGIC and footer_len <= size - _TRAILER.size
    except OSError:
        return False


# Probe results keyed by the directory's stat fingerprint (per-file name,
# size, mtime): the probe only ever runs on legacy pre-repository
# directories and crash victims, both effectively immutable — anything
# written through the repository carries a marker or a manifest and is
# classified without probing. A stat sweep is metadata-only, so the cache
# removes the expensive part (parsing multi-GB legacy pickles) from the
# committer thread, which re-scans the catalog after every commit.
# Bounded: one entry per step directory.
_probe_cache: Dict[str, Tuple[tuple, bool]] = {}
_probe_lock = threading.Lock()


def _dir_fingerprint(sdir: str) -> tuple:
    entries = []
    with os.scandir(sdir) as it:
        for e in it:
            try:
                st = e.stat()
            except OSError:
                continue
            entries.append((e.name, st.st_size, st.st_mtime_ns))
    return tuple(sorted(entries))


def probe_step_complete(sdir: str) -> bool:
    """Best-effort completeness check for a manifest-less step directory.

    * native: every ``*.dsllm`` file must end in a valid footer trailer
      (the engine writes footers last, so a crash victim fails this);
    * snapshot: every chunk referenced by every rank manifest must exist
      with the advertised size;
    * sync: every pickle must parse.

    Results are cached per directory stat fingerprint — ``committed_steps``
    runs after every commit, and re-parsing multi-GB legacy pickles each
    time would put the whole legacy directory's I/O on the committer
    thread.
    """
    if not os.path.isdir(sdir):
        return False
    path = os.path.abspath(sdir)
    try:
        fp = _dir_fingerprint(path)
    except OSError:
        return False
    with _probe_lock:
        cached = _probe_cache.get(path)
    if cached is not None and cached[0] == fp:
        return cached[1]
    result = _probe_step_complete_uncached(sdir)
    with _probe_lock:
        _probe_cache[path] = (fp, result)
    return result


def _probe_step_complete_uncached(sdir: str) -> bool:
    from repro_torch.core import pickle_compat
    dsllm = glob.glob(os.path.join(sdir, "*.dsllm"))
    if dsllm:
        return all(_dsllm_trailer_ok(p) for p in dsllm)
    manifests = glob.glob(os.path.join(sdir, "manifest_rank*.pkl"))
    if manifests:
        try:
            for mpath in manifests:
                with open(mpath, "rb") as f:
                    manifest = pickle_compat.load(f)
                for t in manifest["tensors"]:
                    for cpath, lo, hi in t["chunks"]:
                        if not os.path.exists(cpath):
                            cpath = os.path.join(
                                sdir, os.path.basename(cpath))
                        if not os.path.isfile(cpath) \
                                or os.path.getsize(cpath) != hi - lo:
                            return False
            return True
        except Exception:  # noqa: BLE001 — any unreadable manifest
            return False
    pkls = glob.glob(os.path.join(sdir, "*.pkl"))
    if pkls:
        for p in pkls:
            try:
                with open(p, "rb") as f:
                    pickle_compat.load(f)
            except Exception:  # noqa: BLE001 — any unparsable pickle
                return False
        return True
    return False
