"""The benchmark's own counts of a kernel's bytes and operations, and the
table of the chip's peaks they are held against."""
