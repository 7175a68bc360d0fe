"""Alignment: the aligner of the torch port (host alignment modules come from pav_tpu.align)."""
