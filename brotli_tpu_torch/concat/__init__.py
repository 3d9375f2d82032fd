"""Lossless concatenation of brotli streams (BroCatli)."""
