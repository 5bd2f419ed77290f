"""Sequence parallelism over the mesh's `seq` axis: Ulysses (all_to_all
around the segment kernel K4) and ring attention (P2P)."""
