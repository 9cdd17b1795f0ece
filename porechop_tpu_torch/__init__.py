"""porechop_tpu_torch: the PyTorch/CUDA port of porechop_tpu, an adapter
trimmer for Oxford Nanopore reads with the capabilities of rrwick/Porechop
(reference v0.2.4).

Compute path: PyTorch on a CUDA card, with the alignment DP in
hand-written CUDA kernels (csrc/, bound in ops/kernels.py).
Host path: FASTA/FASTQ IO, trim/split/bin decision logic, CLI.
"""

from .version import __version__

__all__ = ['__version__']
