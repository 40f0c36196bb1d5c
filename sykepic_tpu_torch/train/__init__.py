"""Training-side configuration (this slice: what inference reads)."""
