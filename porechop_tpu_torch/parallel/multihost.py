"""Multi-process execution over torch.distributed (counterpart of
porechop_tpu/parallel/multihost.py).

The reference parallelizes inside one process with a thread pool over
(read, adapter) items (reference porechop/porechop.py:24,308-322).  The
scale-out level here is processes, each owning a contiguous block of the
input reads and its own device.  Only one decision is global (which
adapter sets are present), so the per-(set, side) best-identity stats merge
across processes with one collective (an allgather of two small int
vectors + an exact-fraction fold); phases 2 and 3 and serialization are
purely per-block, and each process writes its block to a part file that
rank 0 concatenates in rank order, making the merged bytes identical to a
single-process run over the same reads.

Input I/O is partitioned (reference porechop.py:224-283): every rank runs a
cheap record-counting scan, then parses and materializes ONLY its own
record block (plus its slice of the --check_reads sample head), so N ranks
hold 1/N of the reads each and decode 1/N of the records into objects.
PORECHOP_TPU_LOAD_STATS=<path> makes each rank write how many records it
decoded into reads, and of how many, to <path>.rank<r> as JSON.

Verbosity contract: rank 0 prints the full reference transcript
byte-identically to a single-process run.  At -v 1 it is rebuilt from
globally-aggregated counters (progress totals, trim summaries, bin
tables: all v1 text is a pure function of those); at -v >= 2 each rank's
per-read dump lines are gathered (gather_text_blocks) and re-emitted in
global read order (the ranks own contiguous read blocks, so rank-ordered
concatenation IS read order).

Backend: gloo.  Every collective here carries small host arrays
(detection stats, counters and dump text); no device tensor crosses
ranks, so NCCL is not needed, and NCCL cannot put two ranks on one card,
which gloo does.

Activation: set PORECHOP_TPU_COORDINATOR=host:port (rank 0's address),
PORECHOP_TPU_NUM_PROCS and PORECHOP_TPU_PROC_ID on every process and run
the same CLI command.  Each rank runs on cuda:(rank % cards) unless the
caller names a device.  The input path and the output destination (-o
file / -b dir) must be visible to every rank (shared storage): part files
are written next to the final output and concatenated by rank 0; all other
cross-rank traffic goes over the collectives, not the filesystem.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..pipeline import output, stream

# How long a collective waits for the slowest rank.  Ranks meet after their
# blocks' phases, and equal record counts keep their walls close; a dead
# rank closes its connections and fails the others at once, so this bounds
# only a rank that hangs.
_TIMEOUT = datetime.timedelta(hours=1)


def maybe_init() -> bool:
    """Joins the torch.distributed process group named by the
    PORECHOP_TPU_* environment (no-op when unset) and returns True when
    running multi-process.  Ranks > 0 get fd 1 silenced: no rank but 0
    ever legitimately writes to stdout (parts go through files and rank 0
    merges them), and in stdout-output mode fd 1 carries reads."""
    coord = os.environ.get('PORECHOP_TPU_COORDINATOR')
    if not coord:
        return False
    if not dist.is_initialized():
        dist.init_process_group(
            'gloo', init_method='tcp://' + coord,
            world_size=int(os.environ.get('PORECHOP_TPU_NUM_PROCS', '1')),
            rank=int(os.environ.get('PORECHOP_TPU_PROC_ID', '0')),
            timeout=_TIMEOUT)
    if not enabled():
        return False
    if rank() > 0:
        sys.stdout.flush()
        devnull_fd = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull_fd, 1)
        os.close(devnull_fd)
    return True


def enabled() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank()


def world() -> int:
    return dist.get_world_size()


def rank_device() -> torch.device:
    """This rank's card: cuda:(rank % cards), so that ranks spread over a
    host's cards and share them when there are more ranks than cards."""
    return torch.device('cuda', rank() % torch.cuda.device_count())


def block_slice(n: int):
    """Contiguous block partition of n items for this process: rank r gets
    [r*n//W, (r+1)*n//W), order-preserving, so rank-ordered concatenation
    of outputs reproduces the single-process output order."""
    w, r = world(), rank()
    return (r * n) // w, ((r + 1) * n) // w


def sync():
    """A barrier of every rank."""
    dist.barrier()


def finish():
    """Ends a multi-process run (no-op otherwise): a last barrier, then the
    process group's teardown, so that no rank exits while another still
    talks to it and gloo's threads stop before the interpreter does (a
    rank left to tear the group down at exit was seen to abort, under
    load, in `terminate called without an active exception`)."""
    if enabled():
        sync()
        dist.destroy_process_group()


def _allgather(local: np.ndarray) -> np.ndarray:
    """Every rank's equally-shaped `local`, stacked in rank order:
    (world, *local.shape)."""
    t = torch.from_numpy(np.ascontiguousarray(local))
    out = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def sum_across_ranks(values):
    """Element-wise sum of a small int vector across all processes (the v1
    transcript's global trim/middle counters)."""
    return _allgather(np.asarray(values, np.int64)).sum(axis=0)


def load_reads_block(input_file_or_directory, verbosity, print_dest,
                     check_read_count):
    """Partitioned twin of pipeline.phases.load_reads (reference
    porechop.py:224-283): a cheap record-counting scan first, then parses
    that build ONLY this rank's contiguous record block and its slice of
    the global --check_reads sample.  For file input, check read g is
    record g, so the check reads inside the block are the block's own
    Read objects, as a single process shares them.  The v1 'Loading
    reads' text prints GLOBAL totals, as a single-process run would.
    Returns (reads_block, check_block, read_type, n_total,
    n_check_total)."""
    input_ = input_file_or_directory
    if not os.path.exists(input_):
        sys.exit('Error: could not find ' + input_)
    n = stream.count_records(input_)
    if verbosity > 0:
        stream.print_load_text(input_, print_dest, total=n)
    lo, hi = block_slice(n)
    reads = list(stream.iter_input_reads(input_, (lo, hi)))
    _, n_check = stream.collect_check_reads(input_, check_read_count,
                                            record_range=(0, 0))
    clo, chi = block_slice(n_check)
    if os.path.isdir(input_):
        # Per-file heads: a check index is not a record index.
        check, _ = stream.collect_check_reads(input_, check_read_count,
                                              record_range=(clo, chi))
        built = len(reads) + len(check)
    else:
        # clo <= lo and chi <= hi (n_check <= n): the slice's part before
        # the block is parsed, the rest shared.
        check = []
        if clo < min(chi, lo):
            check, _ = stream.collect_check_reads(
                input_, check_read_count, record_range=(clo, min(chi, lo)))
        built = len(reads) + len(check)
        check += reads[max(clo, lo) - lo:max(chi - lo, 0)]
    stats_path = os.environ.get('PORECHOP_TPU_LOAD_STATS')
    if stats_path:
        with open('%s.rank%d' % (stats_path, rank()), 'w') as f:
            json.dump({'materialized': built, 'total': n}, f)
    return reads, check, stream.input_read_type(input_), n, n_check


def fold_detection_stats(allv):
    """Folds (world, E, 2) per-rank (matches, full_len) pairs under the
    exact-fraction order (m / l, compared as m * l' > m' * l in int64):
    per entry the first rank's pair unless a later rank's is strictly
    better.  Returns (best_m, best_l), with every full_len at least 1."""
    best_m = allv[0, :, 0].copy()
    best_l = np.maximum(allv[0, :, 1], 1)
    for k in range(1, allv.shape[0]):
        m, l = allv[k, :, 0], np.maximum(allv[k, :, 1], 1)
        better = m * best_l > best_m * l
        best_m[better] = m[better]
        best_l[better] = l[better]
    return best_m, best_l


def merge_detection_stats(gm, gl):
    """All-gathers the per-(set, side) best (matches, full_len) pairs and
    folds them under the exact-fraction order, so every process sees the
    global detection maxima (the reference's shared-memory max,
    nanopore_read.py:155-164, across processes)."""
    local = np.stack([np.asarray(gm, np.int64),
                      np.asarray(gl, np.int64)], axis=1)   # (E, 2)
    return fold_detection_stats(_allgather(local))


# Per-round allgather payload of gather_text_blocks, in bytes: every rank
# holds O(world x chunk) transient bytes per round, never O(world x dump).
GATHER_CHUNK = 4 << 20


def gather_text_blocks(text: str, sink=None):
    """All-gathers each rank's text block over the collective (NOT through
    the filesystem: ranks on different hosts share no /tmp).  On rank 0,
    streams the rank-ordered concatenation into `sink` (a text file
    object) and returns None, or returns it as a string when sink is None;
    returns None on other ranks.  Used for the -v >= 2 per-read dumps,
    whose global order is the concatenation of the ranks' contiguous read
    blocks.

    The gather runs in rounds of GATHER_CHUNK bytes per rank,
    so transient memory is O(world x chunk) on every rank regardless of
    dump size; rank 0 spools ranks' dumps to anonymous temp files (O(total)
    disk, the size of the text it is about to print) and streams them out
    in rank order through an incremental UTF-8 decoder (multi-byte
    characters may split across chunk boundaries)."""
    import codecs
    import tempfile

    raw = text.encode('utf-8')
    lens = _allgather(np.array([len(raw)], np.int64)).reshape(-1)
    width = int(lens.max())
    chunk = GATHER_CHUNK
    w, r = world(), rank()

    if width <= chunk:                       # common case: one round
        padded = np.zeros(max(1, width), np.uint8)
        padded[:len(raw)] = np.frombuffer(raw, np.uint8)
        allv = _allgather(padded)
        if r != 0:
            return None
        pieces = (allv[k, :int(lens[k])].tobytes().decode('utf-8')
                  for k in range(w))
        if sink is None:
            return ''.join(pieces)
        for p in pieces:
            sink.write(p)
        return None

    spools = [tempfile.TemporaryFile() for _ in range(w)] if r == 0 else None
    for t in range(-(-width // chunk)):
        lo = t * chunk
        piece = raw[lo:lo + chunk]
        padded = np.zeros(chunk, np.uint8)
        padded[:len(piece)] = np.frombuffer(piece, np.uint8)
        allv = _allgather(padded)
        if r == 0:
            for k in range(w):
                take = min(max(int(lens[k]) - lo, 0), chunk)
                if take:
                    spools[k].write(allv[k, :take].tobytes())
    if r != 0:
        return None
    out = [] if sink is None else None
    for k in range(w):
        dec = codecs.getincrementaldecoder('utf-8')()
        spools[k].seek(0)
        while True:
            b = spools[k].read(chunk)
            s = dec.decode(b, final=not b)
            if s:
                if sink is None:
                    out.append(s)
                else:
                    sink.write(s)
            if not b:
                break
        spools[k].close()
    return ''.join(out) if sink is None else None


def _part_path(base: str, r: int) -> str:
    return '%s.mhpart%04d' % (base, r)


def output_and_merge(reads, args, read_type):
    """Per-rank serialization + rank-0 merge of an in-memory read block."""
    def write_block(dest_path, plain):
        if args.barcode_dir is not None:
            return output.output_reads(
                reads, plain, None, read_type, 0, args.discard_middle,
                args.min_split_read_size, args.print_dest, dest_path,
                args.input, args.untrimmed, args.threads,
                args.discard_unassigned, return_counts=True)
        output.output_reads(reads, plain, dest_path, read_type, 0,
                            args.discard_middle, args.min_split_read_size,
                            args.print_dest, None, args.input, args.untrimmed,
                            args.threads, args.discard_unassigned)

    write_block_and_merge(args, read_type, write_block)


def write_block_and_merge(args, read_type, write_block_fn,
                          pre_merge_hook=None):
    """The shared merge harness: every rank writes its block PLAIN (no
    compression) via `write_block_fn(dest_path, plain_format)` (a part
    file for -o/stdout runs, a part bin-directory for -b runs, when it must
    return the {bin: (reads, bases)} counts dict) and after a barrier
    rank 0 concatenates parts in rank order with chunked copies and applies
    compression / final placement, so the merged artifact is byte-identical
    to a single-process run.  Also emits the output-section v1 text
    (reference porechop.py:607-734) from the merged state.

    pre_merge_hook (optional) runs after the parts are written but before
    any output-section text: the streaming composition prints its deferred
    phase transcript there (the counters only exist once the chunks have
    flowed)."""
    out_format = output.resolve_format(args.format, args.output, read_type,
                                       args.barcode_dir, args.input)
    plain = out_format[:-3] if out_format.endswith('.gz') else out_format
    r, w = rank(), world()
    gz = out_format.endswith('.gz')

    if args.barcode_dir is not None:
        part_dir = os.path.join(args.barcode_dir, '.mh%04d' % r)
        counts = write_block_fn(part_dir, plain)
        if not os.path.isdir(part_dir):     # rank wrote no reads at all
            os.makedirs(part_dir)
        with open(os.path.join(part_dir, 'counts.json'), 'w') as f:
            json.dump(counts or {}, f)
        part = None
    else:
        if args.output is None:
            part = _part_path('PORECHOP_TPU_STDOUT_%d' % _run_tag(), r)
        else:
            part = _part_path(args.output, r)
        write_block_fn(part, plain)

    if pre_merge_hook is not None:
        pre_merge_hook()

    # Output-section v1 text (reference porechop.py:607-651): the 'Saving'
    # banner and the pigz/gzip election line print in the single-process
    # positions; ranks > 0 print to devnull, keeping control flow SPMD.
    if args.verbosity > 0:
        output.print_output_banner(args.untrimmed, args.barcode_dir,
                                   args.output, args.print_dest)
    gzip_cmd = (output.gzip_command_for(
        args.threads, args.verbosity if r == 0 else 0) if gz else 'gzip')

    if args.barcode_dir is not None:
        sync()
        if r == 0:
            _merge_bins(args, plain, gz, gzip_cmd)
        sync()
        if args.verbosity > 0:
            print('', flush=True, file=args.print_dest)
        return

    sync()
    # Each rank reports its part's byte count (-1: never opened, a rank
    # with an empty block's lazy streaming sink); rank 0 verifies it can
    # see exactly those bytes before merging.  A part written to
    # non-shared storage (or truncated) must fail loudly instead of
    # silently dropping a rank's reads from the merged output.
    local_sz = (os.path.getsize(part)
                if part is not None and os.path.isfile(part) else -1)
    part_sizes = _allgather(np.array([local_sz], np.int64)).reshape(-1)
    if r == 0:
        parts = [(_part_path('PORECHOP_TPU_STDOUT_%d' % _run_tag(), k)
                  if args.output is None else _part_path(args.output, k))
                 for k in range(w)]
        for k, p in enumerate(parts):
            want = int(part_sizes[k])
            if want < 0:
                continue
            have = os.path.getsize(p) if os.path.isfile(p) else -1
            if have != want:
                sys.exit('Error: multi-process merge: rank %d wrote %d '
                         'bytes to %s but rank 0 sees %s; the output '
                         'location must be on storage shared by every rank'
                         % (k, want, p,
                            'no file' if have < 0 else '%d bytes' % have))
        parts = [p for k, p in enumerate(parts) if part_sizes[k] >= 0]
        if args.output is None:
            sys.stdout.flush()
            for p in parts:
                with open(p) as f:
                    shutil.copyfileobj(f, sys.stdout)
                os.remove(p)
        else:
            target = args.output if not gz else args.output + '.mhplain'
            # Chunked copies: rank 0 merges at exactly the scale where
            # whole-file reads would defeat bounded memory.
            with open(target, 'wb') as out:
                for p in parts:
                    with open(p, 'rb') as f:
                        shutil.copyfileobj(f, out)
                    os.remove(p)
            if gz:
                output.gzip_into(gzip_cmd, target, args.output)
    sync()
    if args.verbosity > 0:
        output.print_output_done(args.output, args.print_dest)
        print('', flush=True, file=args.print_dest)


def _run_tag() -> int:
    """A tag shared by all ranks of one run (parts must agree on names):
    the coordinator port is unique per run on a machine."""
    coord = os.environ.get('PORECHOP_TPU_COORDINATOR', ':0')
    try:
        return int(coord.rsplit(':', 1)[1])
    except ValueError:
        return 0


def _merge_bins(args, plain_format, gzipped, gzip_command='gzip'):
    """Rank 0: append each rank's bin parts in rank order, aggregate the
    counts, compress, and print the counts table (reference
    porechop.py:679-704) from the aggregated numbers."""
    bins = {}
    for k in range(world()):
        part_dir = os.path.join(args.barcode_dir, '.mh%04d' % k)
        with open(os.path.join(part_dir, 'counts.json')) as f:
            counts = json.load(f)
        for name, (rc, bc) in counts.items():
            have = bins.get(name, (0, 0))
            bins[name] = (have[0] + rc, have[1] + bc)
            src = os.path.join(part_dir, name + '.' + plain_format)
            dst = os.path.join(args.barcode_dir, name + '.' + plain_format)
            with open(dst, 'ab') as out, open(src, 'rb') as f:
                shutil.copyfileobj(f, out)
            os.remove(src)
        os.remove(os.path.join(part_dir, 'counts.json'))
        os.rmdir(part_dir)
    output.finish_bins(bins, args.barcode_dir, plain_format, gzipped,
                       gzip_command, args.verbosity, args.print_dest)
