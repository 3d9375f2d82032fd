"""catbrotli CLI: concatenate brotli files losslessly
(reference src/bin/catbrotli.rs parity: N input files, optional -w
window override, '-' for stdout).  A copy of
brotli_tpu/cli/catbrotli_cli.py on the port's BroCatli.

    python -m brotli_tpu_torch.cli.catbrotli_cli out.br in1.br in2.br
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    window = 0
    files = []
    for a in args:
        if a in ("-h", "--help"):
            sys.stdout.write(
                "usage: catbrotli [-w#] output.br input1.br input2.br"
                " ...\n  (use '-' for stdout)\n")
            return 0
        if a.startswith("-w"):
            window = int(a[2:])
        elif a.startswith("-"):
            sys.stderr.write(f"unknown flag {a}\n")
            return 2
        else:
            files.append(a)
    if len(files) < 2:
        sys.stderr.write("need an output and at least one input\n")
        return 2
    out_path, inputs = files[0], files[1:]

    from ..concat.brocatli import concatenate
    streams = []
    for p in inputs:
        with open(p, "rb") as f:
            streams.append(f.read())
    joined = concatenate(streams, window_size=window)
    if out_path == "-":
        sys.stdout.buffer.write(joined)
    else:
        with open(out_path, "wb") as f:
            f.write(joined)
    return 0


if __name__ == "__main__":
    sys.exit(main())
