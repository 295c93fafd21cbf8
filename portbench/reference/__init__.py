"""The plain reference the benchmark holds the program to.

Plain PyTorch (on whatever device the tensors live), written from the
semantics the configurations state and from the published algorithms:
the capacity-padded edge list and its slot rule (``graph``), PageRank
with implicit self-loops (``pagerank``), Threefry-2x32 as JAX draws it
(``threefry``), decay-terminated random walks (``walks``) and the
one-step-unrolled Monte-Carlo PPR estimate (``ppr``).  Nothing here
imports the program under test, JAX, or anything the program made: the
harness hands the same generated graph, feed and queries to both sides.
"""
