"""Alignment core: CIGAR codec, alignment table, aligner, trimming, liftover."""
