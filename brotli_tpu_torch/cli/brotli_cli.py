"""brotli CLI (reference src/bin/brotli.rs parity).

A copy of brotli_tpu/cli/brotli_cli.py on the port's encoder, decoder
and utils/: the same flags, output, messages and exit codes.

    python -m brotli_tpu_torch.cli.brotli_cli [-c] [-q9] in out

Decompresses by default; -c switches to compression.  Flag surface
mirrors the reference (bin/brotli.rs:551-835): -q/-0..-11 (incl. -q9.5),
-w window, -l lgblock, -j threads, -b benchmark repeat, -catable /
-appendable / -bare / -bytealign / -magic, -customdictionary=FILE,
-utf8/-msb/-lsb/-signed context modes, -validate, -nothreadpool,
-bytescore=, -largewindow, -i (IR dump).
"""

from __future__ import annotations

import hashlib
import sys
import time


def usage() -> str:
    return (
        "usage: brotli [-c] [-q#|-#] [-w#] [-l#] [-j#] [-b#] [options] "
        "[input [output]]\n"
        "  decompresses by default; -c compresses\n"
        "  -q# | -#        quality 0-11 (also -q9.5, -q9.5x)\n"
        "  -w#             log2 window size (10-24; 30 with -largewindow)\n"
        "  -l#             log2 input block size\n"
        "  -j#             number of parallel parts (max 16)\n"
        "  -b#             benchmark: repeat # times, report speed\n"
        "  -catable -appendable -bare -bytealign -magic\n"
        "  -customdictionary=FILE   LZ77 dictionary\n"
        "  -utf8 -msb -lsb -signed  literal context mode\n"
        "  -largewindow    enable >16MiB windows\n"
        "  -bytescore=#    match scoring literal byte score\n"
        "  -validate       decompress output and SHA-256 compare\n"
        "  -nothreadpool   compress parts serially\n"
        "  -i              dump command IR instead of compressing\n"
    )


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    opts = dict(compress=False, quality=11, q9_5=False,
                q10_deep=False, lgwin=22,
                lgblock=0, threads=1, bench=0, catable=False,
                appendable=False, bare=False, byte_align=False,
                magic=False, dictionary=b"", mode=0, large_window=False,
                byte_score=540, validate=False, serial=False,
                ir_dump=False, findprior=False, findspeed=False,
                stride_quality=0, speed=None, efficient=False,
                avoid_dps=False)
    files = []
    for a in args:
        if a in ("-h", "--help"):
            sys.stdout.write(usage())
            return 0
        if a == "-c":
            opts["compress"] = True
        elif a == "-i":
            opts["ir_dump"] = True
            opts["compress"] = True
        elif a in ("-q9.5", "-q9.5x", "-q9.5y"):
            # reference mapping (bin/brotli.rs:658-680): 9.5 -> q10,
            # 9.5x -> q11, 9.5y -> q12 (a deeper refinement tier)
            opts["quality"] = {"-q9.5": 10, "-q9.5x": 11,
                               "-q9.5y": 12}[a]
            opts["q9_5"] = True
            opts["compress"] = True
        elif a == "-q10deep":
            opts["quality"] = 10
            opts["q10_deep"] = True
            opts["compress"] = True
        elif a.startswith("-q"):
            opts["quality"] = int(float(a[2:]))
            opts["compress"] = True
        elif a.startswith("-w"):
            opts["lgwin"] = int(a[2:])
        elif a.startswith("-l") and a[2:].isdigit():
            opts["lgblock"] = int(a[2:])
        elif a.startswith("-j"):
            opts["threads"] = min(16, int(a[2:]))
        elif a.startswith("-b") and a[2:].isdigit():
            opts["bench"] = int(a[2:])
        elif a == "-catable":
            opts["catable"] = True
            opts["compress"] = True
        elif a == "-appendable":
            opts["appendable"] = True
            opts["compress"] = True
        elif a == "-bare":
            opts["bare"] = True
        elif a == "-bytealign":
            opts["byte_align"] = True
        elif a == "-magic":
            opts["magic"] = True
        elif a.startswith("-customdictionary="):
            with open(a.split("=", 1)[1], "rb") as f:
                opts["dictionary"] = f.read()
        elif a == "-utf8":
            opts["mode"] = 1
        elif a in ("-msb", "-lsb", "-signed"):
            opts["mode"] = 0 if a != "-signed" else 2
        elif a == "-largewindow":
            opts["large_window"] = True
        elif a.startswith("-bytescore="):
            opts["byte_score"] = int(a.split("=", 1)[1])
        elif a == "-validate":
            opts["validate"] = True
        elif a == "-nothreadpool":
            opts["serial"] = True
        elif a == "-dump-dictionary":
            # reference bin/brotli.rs:585: print the RFC static
            # dictionary and exit
            from ..core.dictionary import get_dictionary
            sys.stdout.buffer.write(bytes(get_dictionary().data))
            return 0
        elif a == "-efficient":
            # favor_cpu_efficiency (reference bin/brotli.rs:605)
            opts["efficient"] = True
        elif a == "-lowlatency":
            opts["efficient"] = False
        elif a == "-avoiddistanceprefixsearch":
            opts["avoid_dps"] = True
        elif a == "-findprior":
            opts["findprior"] = True
            opts["compress"] = True
        elif a == "-findspeed":
            opts["findspeed"] = True
            opts["compress"] = True
        elif a in ("-basicstride", "-advstride", "-stride"):
            opts["stride_quality"] = 1 if a == "-basicstride" else 2
            opts["compress"] = True
        elif a.startswith("-speed="):
            inc, cap = a.split("=", 1)[1].split(",")
            opts["speed"] = (int(inc), int(cap))
        elif a.lstrip("-").isdigit() and a.startswith("-"):
            opts["quality"] = int(a.lstrip("-"))
            opts["compress"] = True
        elif a.startswith("-"):
            sys.stderr.write(f"unknown flag {a}\n{usage()}")
            return 2
        else:
            files.append(a)

    data = _read(files[0] if files else None)

    reps = max(1, opts["bench"])
    t0 = time.perf_counter()
    for _ in range(reps):
        out = _run_one(data, opts)
    dt = (time.perf_counter() - t0) / reps
    if opts["bench"]:
        mbps = len(data) / max(dt, 1e-9) / 1e6
        sys.stderr.write(f"{len(data)} bytes in {dt:.3f}s = "
                         f"{mbps:.1f} MB/s\n")
    if opts["ir_dump"]:
        sys.stdout.write(out.decode())
        return 0
    _write(files[1] if len(files) > 1 else None, out)
    return 0


def _run_one(data: bytes, opts) -> bytes:
    from .. import compress, compress_multi, decompress

    speed_info = None
    if opts["findspeed"]:
        # derive speeds from the ENCODER'S OWN literal stream: run the
        # real encode with the live metablock callback and score
        # adaptation speeds over the literals it actually emitted
        import numpy as np

        from ..utils.ir import Literal
        from ..utils.prior import find_speed
        lits = bytearray()
        compress(data, quality=min(opts["quality"], 9),
                 lgwin=opts["lgwin"],
                 metablock_callback=lambda ir, region: lits.extend(
                     b"".join(c.data for c in ir
                              if isinstance(c, Literal))))
        la = np.frombuffer(bytes(lits), np.uint8).astype(np.int64)
        ctx = np.concatenate([[0], la[:-1] >> 4]) if len(la) else \
            np.zeros(0, np.int64)
        cm_speed, _ = find_speed(la, ctx, 16)
        speed_info = cm_speed
        sys.stderr.write(
            f"cmspeedinc {cm_speed[0]} cmspeedmax {cm_speed[1]}\n")
    if opts["findprior"]:
        from ..utils.prior import prior_eval
        rep = prior_eval(data)
        speed_info = speed_info or rep.cm_speed
        sys.stderr.write(
            f"stride {rep.stride} priors {' '.join(rep.per_context)}\n"
            f"priormask {rep.bitmask:#06x} mixweight {rep.mix_weight}\n"
            f"cmspeedinc {rep.cm_speed[0]} cmspeedmax {rep.cm_speed[1]} "
            f"stspeedinc {rep.stride_speed[0]} "
            f"stspeedmax {rep.stride_speed[1]}\n"
            f"costs {rep.costs}\n")
    if opts["stride_quality"]:
        from ..utils.analysis import analyze
        res = analyze(data,
                      stride_detection_quality=opts["stride_quality"])
        sys.stderr.write(
            f"stride {res.best_stride} costs {res.stride_costs}\n")

    if not opts["compress"]:
        return decompress(data, custom_dictionary=opts["dictionary"],
                          large_window=opts["large_window"])
    if opts["ir_dump"]:
        from ..utils.ir import dump_ir
        kw = {}
        if opts["speed"]:
            kw["cm_speed"] = opts["speed"]
            kw["stride_speed"] = opts["speed"]
        elif speed_info:
            kw["cm_speed"] = speed_info
        return dump_ir(data, quality=opts["quality"],
                       lgwin=opts["lgwin"], **kw).encode()
    if opts["threads"] > 1 and not opts["dictionary"]:
        out = compress_multi(data, opts["threads"],
                             quality=opts["quality"], lgwin=opts["lgwin"],
                             mode=opts["mode"],
                             backend="serial" if opts["serial"]
                             else "workpool",
                             favor_cpu_efficiency=opts["efficient"])
    else:
        out = compress(
            data, quality=opts["quality"], lgwin=opts["lgwin"],
            lgblock=opts["lgblock"], mode=opts["mode"],
            catable=opts["catable"], appendable=opts["appendable"],
            bare=opts["bare"], byte_align=opts["byte_align"],
            magic_number=opts["magic"],
            custom_dictionary=opts["dictionary"],
            large_window=opts["large_window"], q9_5=opts["q9_5"],
            q10_deep=opts["q10_deep"],
            literal_byte_score=opts["byte_score"],
            avoid_distance_prefix_search=opts["avoid_dps"])
    if opts["validate"]:
        from .. import decompress as dec
        rt = dec(out, custom_dictionary=opts["dictionary"],
                 large_window=opts["large_window"])
        if hashlib.sha256(rt).digest() != hashlib.sha256(data).digest():
            raise RuntimeError("validation failed: round-trip mismatch")
        sys.stderr.write("validation OK\n")
    return out


def _read(path):
    if path in (None, "-"):
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path, data):
    if path in (None, "-"):
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


if __name__ == "__main__":
    sys.exit(main())
