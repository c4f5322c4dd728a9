"""Several devices in one process: DP over reads x TP over the index.

Counterpart of bwbble_tpu/parallel/shard.py.  The reference scales with
OpenMP threads over a shared read-only index on one node
(align_reads_inexact_parallel, inexact_match.c:92-168).  Here one process
drives a [dp, tp] grid of devices, as JAX's single-controller `shard_map`
does:

- **dp axis**: reads are data-parallel.  Each dp member runs the search on
  its own contiguous slice of the batch, with its own replica of the index
  on its own device; on CUDA tensors that is one launch of the fixed
  kernel a member.  No communication on this axis.  Every member's inputs
  are staged on its device before any member launches (`_stage`), every
  member's launch is prepared (outputs, scratch, the kernel loaded on its
  card), then the members launch back to back, and no result is
  collected before the last launch (the kernel's wrapper does not
  synchronise), so the members' launches run at once, as the dp members
  of the JAX package's `shard_map` do.  A copy between cards is queued on
  the source card's stream: staged inside its member's dispatch, it would
  wait there behind the launch of the member before.
- **tp axis**: the index is range-sharded.  Each member of a mesh row holds
  a contiguous range of the table's blocks, the last one zero-padded.  The
  search state of a row lives on its first member.  On CUDA tensors the
  search kernel, launched there, reads each rank row from the shard that
  owns its block, on that card or on a peer card over NVLink: `place`
  enables peer access from each row's first card to the row's other
  cards, once a pair (a row that names one card several times, as a mesh
  on one card does, needs none), and a pair that cannot reach its peer
  raises; no shard is copied in its place.  The D pass and SA resolution
  take rows through engine.rank._take_rows: each shard gathers on its own
  device, the others contribute zeros, and the rows are summed on the
  query's device (the JAX package's psum over tp).  On CPU tensors the
  search runs the plain version on the same shards.

Outputs come back on the device of the index given, in lane order: lanes
padded to a dp multiple (zero-length reads) are cut off, the arena is
joined on its lane axis and `o_lane` counts lanes globally, so walk_paths
works on the joined arena with global lane ids.
"""

from __future__ import annotations

import dataclasses

import torch

from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.engine.device_index import DeviceIndex
from bwbble_tpu_torch.engine.dpass import chunk_bounds
from bwbble_tpu_torch.engine.inexact import EngineConfig, inexact_search
from bwbble_tpu_torch.engine.rank import sa_resolve


@dataclasses.dataclass(eq=False)
class Mesh:
    """A [dp, tp] grid of devices (`devices[d][t]`), and the index last
    placed on it (`place`).  The alignment pipeline, handed a mesh, runs
    its launches and its D-bound chunks through `inexact_search` and
    `chunk_bounds`."""
    devices: tuple
    _placed: tuple | None = None     # (index given, its members)

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    def place(self, didx: DeviceIndex) -> list[DeviceIndex]:
        """The index as each dp member holds it: a replica on the member's
        first device, its table range-sharded over the row when tp > 1 (on
        CUDA devices with peer access from the row's first card to each
        other card of the row, `peer_pairs`).  Made once an index (a
        batch's call finds it placed)."""
        if self._placed is not None and self._placed[0] is didx:
            return self._placed[1]
        if any(dev.type != didx.device.type
               for row in self.devices for dev in row):
            raise ValueError(f"the mesh's devices and the index "
                             f"({didx.device}) differ in type")
        tp = self.shape["tp"]
        if tp > 1 and didx.device.type == "cuda":
            from bwbble_tpu_torch.engine import kernel
            for dev, peer in peer_pairs(self):
                kernel.enable_peer(dev, peer)
        table = pad_index_for_tp(didx, tp).table
        nloc = table.shape[0] // tp
        members = []
        for row in self.devices:
            tables = tuple(table[t * nloc:(t + 1) * nloc].to(row[t])
                           for t in range(tp))
            members.append(DeviceIndex(
                table=tables[0], Carr=didx.Carr.to(row[0]),
                sa_samples=didx.sa_samples.to(row[0]), length=didx.length,
                sa0=didx.sa0, tp_tables=tables if tp > 1 else None))
        self._placed = (didx, members)
        return members

    def inexact_search(self, didx: DeviceIndex, rc, lengths, D, D_seed,
                       params: AlnParams, cfg: EngineConfig,
                       timers=None) -> dict:
        return sharded_inexact_search(self, didx, rc, lengths, D, D_seed,
                                      params, cfg, timers)

    def chunk_bounds(self, didx: DeviceIndex, seq, lengths,
                     params: AlnParams, K: int):
        return sharded_calc_d_chunk(self, didx, seq, lengths, params, K)


def peer_pairs(mesh: Mesh) -> list[tuple]:
    """(a row's first device, another device of that row) for every pair of
    distinct devices across which a sharded launch reads, once each."""
    out: list[tuple] = []
    for row in mesh.devices:
        for dev in row[1:]:
            if dev != row[0] and (row[0], dev) not in out:
                out.append((row[0], dev))
    return out


def make_mesh(dp: int, tp: int = 1, devices=None) -> Mesh:
    """A (dp, tp) device mesh over `devices` (default: every CUDA device);
    dp*tp must not exceed the devices given."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if dp * tp > len(devices):
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, "
                         f"have {len(devices)}")
    return Mesh(tuple(tuple(devices[d * tp:(d + 1) * tp])
                      for d in range(dp)))


def pad_index_for_tp(didx: DeviceIndex, tp: int) -> DeviceIndex:
    """Pad the table so num_blocks % tp == 0.

    Padding rows are never gathered (positions are clamped to length-1
    before block lookup), so zero-fill is safe."""
    nb = didx.table.shape[0]
    pad = (-nb) % tp
    if pad == 0:
        return didx
    table = torch.cat([didx.table,
                       didx.table.new_zeros((pad, didx.table.shape[1]))])
    return dataclasses.replace(didx, table=table)


def _pad_batch(arrs, dp: int):
    """Pad the batch dim to a multiple of dp with zeros (zero-length reads,
    which finish at once); returns (padded tensors, valid count)."""
    arrs = tuple(torch.as_tensor(a) for a in arrs)
    B = arrs[0].shape[0]
    pad = (-B) % dp
    if pad == 0:
        return arrs, B
    return tuple(torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                 for a in arrs), B


def _join(parts: list, dev: torch.device, B: int):
    """Per-member outputs (tensors, or dicts of them) joined in lane order
    on `dev`, cut to the B lanes given."""
    if isinstance(parts[0], dict):
        n = parts[0]["n_alns"].shape[0]
        out = {}
        for k in parts[0]:
            ps = [p[k] for p in parts]
            if k == "o_lane":
                ps = [p + d * n for d, p in enumerate(ps)]
            out[k] = _join(ps, dev, B)
        return out
    parts = [p.to(dev) for p in parts]
    return (parts[0] if len(parts) == 1 else torch.cat(parts))[:B]


def _slices(n_total: int, dp: int):
    n = n_total // dp
    return [slice(d * n, (d + 1) * n) for d in range(dp)]


def _stage(members: list, arrs, dtypes) -> list[tuple]:
    """Each dp member's slice of each of `arrs` on the member's device, in
    the type given (None: as it is), contiguous: the inputs its launch
    takes as they are, all copied before any member launches."""
    return [tuple(a[s].to(m.device, dt or a.dtype).contiguous()
                  for a, dt in zip(arrs, dtypes))
            for m, s in zip(members, _slices(arrs[0].shape[0],
                                             len(members)))]


def sharded_inexact_search(mesh: Mesh, didx: DeviceIndex, rc, lengths, D,
                           D_seed, params: AlnParams, cfg: EngineConfig,
                           timers=None) -> dict:
    """inexact_search over a (dp, tp) mesh; the same outputs, the batch
    split on dp.  Every member's inputs are staged on its device and its
    launch prepared first, then the members launch back to back.
    `timers`: None, or one timer a dp member, each handed to its member's
    launch (inexact_search's `timer`)."""
    members = mesh.place(didx)
    arrs, B = _pad_batch((rc, lengths, D, D_seed), len(members))
    staged = _stage(members, arrs, (torch.int8, torch.int32, didx.idt,
                                    didx.idt))
    return _join(_launch_all([
        inexact_search(m, *x, params, cfg, device=m.device, defer=True,
                       timer=None if timers is None else timers[d])
        for d, (m, x) in enumerate(zip(members, staged))]), didx.device, B)


def _launch_all(prepared: list) -> list:
    """Launch the members' prepared searches (inexact_search's `defer`
    callables) back to back; their outputs."""
    return [go() for go in prepared]


def sharded_calc_d_chunk(mesh: Mesh, didx: DeviceIndex, seq, lengths,
                         params: AlnParams, K: int):
    """The D full+seed pass of one batch over a (dp, tp) mesh: exactly the
    math of engine.dpass.chunk_bounds, reads split on dp and the index
    range-sharded on tp.  Returns (D, Ds, overflow)."""
    members = mesh.place(didx)
    (seq, lengths), B = _pad_batch((seq, lengths), len(members))
    outs = [chunk_bounds(m, seq[s], lengths[s], params, K)
            for m, s in zip(members, _slices(seq.shape[0], len(members)))]
    return tuple(_join([o[j] for o in outs], didx.device, B)
                 for j in range(3))


def sharded_align_step(mesh: Mesh, didx: DeviceIndex, seq, rc, lengths,
                       params: AlnParams, cfg: EngineConfig,
                       d_cap: int = 32) -> dict:
    """The whole device alignment step on a (dp, tp) mesh: D bounds, seed-D
    bounds, inexact search, and SA resolution of each read's first
    alignment (`ref_pos`, -1 without one): everything `bwbble align` runs
    a batch (align_reads_inexact, inexact_match.c:46-66)."""
    members = mesh.place(didx)
    arrs, B = _pad_batch((seq, rc, lengths), len(members))
    staged = _stage(members, arrs, (None, torch.int8, torch.int32))
    # every member's inputs staged, then its D pass (member by member),
    # then every member's search prepared and launched back to back
    # before any result is read
    prepared, dovs = [], []
    for m, (seq_m, rc_m, ln_m) in zip(members, staged):
        D, Ds, dov = chunk_bounds(m, seq_m, ln_m, params, d_cap)
        prepared.append(inexact_search(m, rc_m, ln_m, D, Ds, params, cfg,
                                       device=m.device, defer=True))
        dovs.append(dov)
    outs = _launch_all(prepared)
    for out, dov in zip(outs, dovs):
        out["overflow"] = out["overflow"] | dov
    for m, out in zip(members, outs):
        found = out["n_alns"] > 0
        rows = torch.where(found, out["o_L"][:, 0], 0)
        out["ref_pos"] = torch.where(found, sa_resolve(m, rows), -1)
    return _join(outs, didx.device, B)
