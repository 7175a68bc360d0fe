"""Variant calling stages whose density scan runs on the torch port."""
