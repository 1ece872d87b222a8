"""Fused graph engines and the R-MAT generator on one device."""
