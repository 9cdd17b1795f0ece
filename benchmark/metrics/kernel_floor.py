"""The least time in which an NVIDIA H100 could run one launch of the
port's alignment kernels: the same work whatever implements the kernel.

floor = max(operations / int32 issue rate, bytes / memory rate)

Operations.  A launch's lanes need sum(read_len x adapter_len) cells of
the Gotoh recurrence (the inputs' own lengths, not the padded launch).
The fewest instructions a cell can take on Hopper:

  sub   = the substitution score of (read base, adapter base)   1 (a select,
                                                   or a load of a profile)
  Mo    = M + open          (feeds the cell to the right and below)  1
  H     = max(H + ext, Mo_left)             __viaddmax, fused        1
  V     = max(V + ext, Mo_up)               __viaddmax, fused        1
  G     = max(H, V)                         __vimax                  1
  M     = max(M_diag + sub, G)              __viaddmax, fused        1
                                                                   ---
                                                                     6

Every rung's scores fit in 16 bits (adapters of at most 128 bases at
match 3, gaps and mismatches bounded below by the free end gaps), so each
of the six can be the packed `_s16x2` form that does two cells:
3 instructions a cell.  The best cell's election touches only the last
row and column and is not counted.  The rate is every int32 lane of the
card issuing one instruction a clock: 132 SMs x 64 lanes x 1.98 GHz
(the H100 SXM's boost clock at its 700 W limit), 1.6727e13 a second.  A
DPX instruction that issues slower than that only lowers the share.

Bytes.  Inputs read once and outputs written once (chip_smoke._bound's
count): the lanes' read and adapter bases, two int32 lengths a lane, and
the entry point's outputs: forward_score 4 bytes a lane, forward_stats
16, forward_walk 52 (ten int32 walk aggregates, best, cell_i, cell_j;
its trace bits are its own intermediate), forward_tiled 14 and the trace
bits the walker may read (adapter_len x (read_len + 1) a lane).  Over
3.35 TB/s of HBM3.

So no implementation of these entry points can take less time, and a
launch's share of its floor cannot pass 100%.
"""

INT32_LANES = 132 * 64
CLOCK_HZ = 1.98e9
INSTR_RATE = INT32_LANES * CLOCK_HZ
MEM_BPS = 3.35e12
INSTR_PER_CELL = 6 / 2

OUT_BYTES = {'forward_score': 4, 'forward_stats': 16, 'forward_walk': 52,
             'forward_tiled': 14}


def floor_s(name, B, L, A, cells, read_bases, adapter_bases):
    """Seconds of the floor of one launch; None for an entry point whose
    work is not counted (the standalone walk)."""
    if name not in OUT_BYTES or cells is None:
        return None
    nbytes = read_bases + adapter_bases + 8 * B + OUT_BYTES[name] * B
    if name == 'forward_tiled':
        nbytes += cells + adapter_bases
    return max(cells * INSTR_PER_CELL / INSTR_RATE, nbytes / MEM_BPS)
