"""Variant-calling domain logic: CIGAR calls, large SVs, inversions, integration, merging."""
