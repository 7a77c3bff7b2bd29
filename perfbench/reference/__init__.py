"""The benchmark's plain reference: the same profile-HMM semantics as the
system under test, written again in plain PyTorch and NumPy.

It imports nothing of the program and takes nothing the program made but
the outputs it judges (graphs, mappings, copy numbers, scores), which it
reads as plain arrays (:class:`~perfbench.reference.graph.Graph`).  The
PHMM of a graph, the forward recursion and the host arithmetic (genome
size, prior, Euler circuit count, the k+1 extension) are all worked out
here from those arrays.
"""
