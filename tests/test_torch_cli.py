"""The port's brotli and catbrotli command lines against brotli_tpu's,
on the CPU.

Both packages' main(argv) run in this process on the same files (one
directory each, the same names), with sys.stdin / sys.stdout swapped
for io.TextIOWrapper(io.BytesIO()) objects and sys.stderr for a
StringIO.  Each case asserts equal exit codes (or equal exceptions),
stdout bytes, stderr text (the -b timing's numbers masked, its shape
checked) and output files (tolerance: none).  The cases cover every
flag of usage() and of the parser, its quirks included: -j above 1
drops the stream flags, an unknown flag exits 2 with the usage, and
'-' is parsed as an unknown flag in both CLIs, so stdin and stdout are
reached by naming no file.  A subprocess run of each module shows that
it runs as a script.
"""

import io
import os
import re
import subprocess
import sys

import pytest

from brotli_tpu.cli import brotli_cli as JCLI
from brotli_tpu.cli import catbrotli_cli as JCAT
from brotli_tpu_torch import compress
from brotli_tpu_torch.cli import brotli_cli as TCLI
from brotli_tpu_torch.cli import catbrotli_cli as TCAT
from . import oracle
from .test_torch_encoder import ROOT, dictionary_slice, phrases
from .test_torch_utils import records, repo_text
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = repo_text(12_000) + phrases(10_000, seed=41) + records(2_048) \
    + dictionary_slice(90_000, 92_000)
DICTIONARY = phrases(16_000, seed=42)
BENCH = re.compile(r"^(\d+) bytes in \d+\.\d{3}s = \d+\.\d MB/s$")


def files(d) -> dict:
    """The case's input files in directory d."""
    os.makedirs(d, exist_ok=True)
    made = {
        "in.txt": DATA,
        "in.br": compress(DATA, quality=5),
        "dict.bin": DICTIONARY,
        "dict.br": compress(DATA, quality=9, custom_dictionary=DICTIONARY),
        "large.br": compress(DATA, quality=5, lgwin=26, large_window=True),
        "bad.br": compress(DATA, quality=5)[:40] + b"\xff" * 64,
    }
    for name, data in made.items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)
    return made


def run(main, argv, stdin=b""):
    """main(argv) with swapped standard streams: (exit code or the
    exception's type and text, stdout bytes, stderr text)."""
    out = io.BytesIO()
    so = io.TextIOWrapper(out, encoding="utf-8")
    si = io.TextIOWrapper(io.BytesIO(stdin), encoding="utf-8")
    se = io.StringIO()
    saved = sys.stdin, sys.stdout, sys.stderr
    sys.stdin, sys.stdout, sys.stderr = si, so, se
    try:
        try:
            rc = main(argv)
        except Exception as e:  # both packages must fail alike
            rc = f"{type(e).__name__}: {e}"
        so.flush()
    finally:
        sys.stdin, sys.stdout, sys.stderr = saved
    return rc, out.getvalue(), se.getvalue()


def outputs(d) -> dict:
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def mask(err: str) -> str:
    """The -b timing line's numbers masked; its shape checked."""
    lines = []
    for line in err.splitlines(keepends=True):
        m = BENCH.match(line.rstrip("\n"))
        lines.append(f"{m.group(1)} bytes in #s = # MB/s\n" if m else line)
    return "".join(lines)


def both(tmp_path, mains, argv, stdin=b""):
    """Run argv ({d} = the package's directory) through both packages'
    main; assert every result equal; return the port's."""
    got = []
    for pkg, main in zip(("jax", "port"), mains):
        d = str(tmp_path / pkg)
        files(d)
        res = run(main, [a.replace("{d}", d) for a in argv], stdin)
        got.append((res[0], res[1], mask(res[2]), outputs(d)))
    assert got[1] == got[0]
    return got[1]


# argv of each brotli case; {d} is the package's directory
CASES = {
    "decompress": ["{d}/in.br", "{d}/out"],
    "decompress_corrupt": ["{d}/bad.br", "{d}/out"],
    "c_default_q11": ["-c", "{d}/in.txt", "{d}/out"],
    **{f"q{q}": [f"-q{q}", "{d}/in.txt", "{d}/out"] for q in range(12)},
    "dash5": ["-5", "{d}/in.txt", "{d}/out"],
    "q9.5": ["-q9.5", "{d}/in.txt", "{d}/out"],
    "q9.5x": ["-q9.5x", "{d}/in.txt", "{d}/out"],
    "q9.5y": ["-q9.5y", "{d}/in.txt", "{d}/out"],
    "q10deep": ["-q10deep", "{d}/in.txt", "{d}/out"],
    "w18": ["-c", "-q5", "-w18", "{d}/in.txt", "{d}/out"],
    "l16": ["-c", "-q9", "-l16", "{d}/in.txt", "{d}/out"],
    "j4_workpool": ["-c", "-q5", "-j4", "{d}/in.txt", "{d}/out"],
    "j4_nothreadpool": ["-c", "-q5", "-j4", "-nothreadpool", "{d}/in.txt",
                        "{d}/out"],
    "j4_efficient": ["-c", "-q9", "-j4", "-efficient", "{d}/in.txt",
                     "{d}/out"],
    "j4_lowlatency": ["-c", "-q9", "-j4", "-efficient", "-lowlatency",
                      "{d}/in.txt", "{d}/out"],
    "j99_catable_dropped": ["-q5", "-j99", "-catable", "-bare", "-magic",
                            "-largewindow", "{d}/in.txt", "{d}/out"],
    "b2": ["-b2", "-c", "-q5", "{d}/in.txt", "{d}/out"],
    "b3_decompress": ["-b3", "{d}/in.br", "{d}/out"],
    "catable": ["-catable", "-q5", "{d}/in.txt", "{d}/out"],
    "appendable": ["-appendable", "-q5", "{d}/in.txt", "{d}/out"],
    "bare": ["-c", "-q5", "-appendable", "-bare", "{d}/in.txt", "{d}/out"],
    "bytealign": ["-c", "-q9", "-bytealign", "{d}/in.txt", "{d}/out"],
    "magic": ["-c", "-q5", "-magic", "{d}/in.txt", "{d}/out"],
    "customdictionary_compress": ["-c", "-q9", "-customdictionary={d}/"
                                  "dict.bin", "{d}/in.txt", "{d}/out"],
    "customdictionary_decompress": ["-customdictionary={d}/dict.bin",
                                    "{d}/dict.br", "{d}/out"],
    "customdictionary_j4_ignores_j": ["-c", "-q5", "-j4",
                                      "-customdictionary={d}/dict.bin",
                                      "{d}/in.txt", "{d}/out"],
    "utf8": ["-c", "-q5", "-utf8", "{d}/in.txt", "{d}/out"],
    "msb": ["-c", "-q5", "-msb", "{d}/in.txt", "{d}/out"],
    "lsb": ["-c", "-q9", "-lsb", "{d}/in.txt", "{d}/out"],
    "signed": ["-c", "-q5", "-signed", "{d}/in.txt", "{d}/out"],
    "largewindow_w26": ["-c", "-q5", "-largewindow", "-w26", "{d}/in.txt",
                        "{d}/out"],
    "largewindow_decompress": ["-largewindow", "{d}/large.br", "{d}/out"],
    "bytescore": ["-c", "-q9", "-bytescore=300", "{d}/in.txt", "{d}/out"],
    "validate": ["-c", "-q5", "-validate", "{d}/in.txt", "{d}/out"],
    "validate_j4": ["-q9", "-j4", "-validate", "{d}/in.txt", "{d}/out"],
    "ir": ["-i", "{d}/in.txt"],
    "ir_q5_speed": ["-i", "-q5", "-speed=4,1024", "{d}/in.txt"],
    "ir_findspeed": ["-i", "-findspeed", "-q5", "{d}/in.txt"],
    "ir_findprior": ["-i", "-findprior", "{d}/in.txt"],
    "findspeed": ["-findspeed", "-q5", "{d}/in.txt", "{d}/out"],
    "findprior": ["-findprior", "-q9", "{d}/in.txt", "{d}/out"],
    "findspeed_findprior": ["-findspeed", "-findprior", "-q5",
                            "{d}/in.txt", "{d}/out"],
    "basicstride": ["-basicstride", "-q5", "{d}/in.txt", "{d}/out"],
    "advstride": ["-advstride", "-q5", "{d}/in.txt", "{d}/out"],
    "stride": ["-stride", "-q1", "{d}/in.txt", "{d}/out"],
    "dump_dictionary": ["-q5", "-dump-dictionary", "-zzz", "{d}/in.txt"],
    "avoiddistanceprefixsearch": ["-c", "-q11", "-avoiddistanceprefixsearch",
                                  "{d}/in.txt", "{d}/out"],
    "help": ["-c", "-h", "-zzz"],
    "help_long": ["--help"],
    "unknown_flag": ["-c", "-q5", "-zzz", "{d}/in.txt", "{d}/out"],
    "l_not_a_number": ["-c", "-q5", "-lsbx", "{d}/in.txt", "{d}/out"],
    # the parser reads '-' as a flag before it can name stdin or stdout;
    # without file names the CLI reads stdin and writes stdout
    "dash_stdin_stdout": ["-c", "-q5", "-", "-"],
    "dash_stdin_to_file": ["-", "{d}/out"],
    "stdin_stdout_compress": ["-q9"],
    "stdin_stdout_decompress": [],
}
STDIN = {"dash_stdin_stdout": DATA, "stdin_stdout_compress": DATA,
         "dash_stdin_to_file": compress(DATA, quality=9),
         "stdin_stdout_decompress": compress(DATA, quality=9)}
EXIT = {"unknown_flag": 2, "l_not_a_number": 2, "dash_stdin_stdout": 2,
        "dash_stdin_to_file": 2,
        "decompress_corrupt": "BrotliDecodeError: corrupt stream (native "
                              "code -2)"}


@pytest.mark.parametrize("case", CASES)
def test_brotli_cli_matches_jax(case, tmp_path):
    rc, out, err, made = both(tmp_path, (JCLI.main, TCLI.main),
                              CASES[case], STDIN.get(case, b""))
    assert rc == EXIT.get(case, 0)
    if rc != 0:
        assert out == b"" and "out" not in made
        return
    stream = made.get("out", out)
    if case in ("decompress", "b3_decompress", "customdictionary_decompress",
                "largewindow_decompress", "stdin_stdout_decompress"):
        assert stream == DATA
    elif case.startswith("ir") or case in ("help", "help_long"):
        assert out.decode().splitlines()[0].split()[0] in (
            "prediction", "usage:")
    elif case == "dump_dictionary":
        assert out == open(os.path.join(ROOT, "brotli_tpu", "data",
                                        "dictionary.bin"), "rb").read()
    elif case.startswith("customdictionary") or "bare" in case \
            or "largewindow" in case:
        assert len(stream) < len(DATA)
    else:
        assert oracle.decompress(stream, len(DATA) + 1) == DATA


def test_brotli_cli_errors_and_messages(tmp_path):
    """The exit codes and messages the cases above pin."""
    assert run(TCLI.main, ["-h"])[:2] == (0, TCLI.usage().encode())
    rc, out, err = run(TCLI.main, ["-c", "-qq"])
    assert rc == "ValueError: could not convert string to float: 'q'"
    rc, out, err = run(TCLI.main, ["-zzz"])
    assert (rc, out) == (2, b"")
    assert err == "unknown flag -zzz\n" + TCLI.usage()
    _, _, err, _ = both(tmp_path, (JCLI.main, TCLI.main),
                        ["-b2", "-c", "-q5", "{d}/in.txt", "{d}/out"])
    assert err == f"{len(DATA)} bytes in #s = # MB/s\n"
    _, _, err, _ = both(tmp_path, (JCLI.main, TCLI.main),
                        ["-findprior", "-q5", "{d}/in.txt", "{d}/out"])
    assert err.startswith("stride ") and "\npriormask 0x" in err


def _catable_parts(d) -> list:
    os.makedirs(d, exist_ok=True)
    pieces = [DATA[k * 6_000:(k + 1) * 6_000] for k in range(4)]
    paths = []
    for k, piece in enumerate(pieces):
        path = os.path.join(d, f"part{k}.br")
        with open(path, "wb") as f:
            f.write(compress(piece, quality=5, catable=True, lgwin=20))
        paths.append(path)
    return paths


CAT_CASES = {
    "join": ["{d}/joined.br", "{d}/part0.br", "{d}/part1.br",
             "{d}/part2.br", "{d}/part3.br"],
    "join_w22": ["-w22", "{d}/joined.br", "{d}/part0.br", "{d}/part1.br",
                 "{d}/part2.br", "{d}/part3.br"],
    # the parser reads '-' as a flag before it can name stdout
    "dash_output_is_an_unknown_flag": ["-", "{d}/part0.br", "{d}/part1.br",
                                       "{d}/part2.br", "{d}/part3.br"],
    "one_input": ["{d}/joined.br", "{d}/part0.br"],
    "too_few_files": ["{d}/joined.br"],
    "no_files": [],
    "help": ["-w22", "-h"],
    "unknown_flag": ["-x", "{d}/joined.br", "{d}/part0.br"],
    "not_catable": ["{d}/joined.br", "{d}/in.br", "{d}/in.br"],
}


@pytest.mark.parametrize("case", CAT_CASES)
def test_catbrotli_cli_matches_jax(case, tmp_path):
    for pkg in ("jax", "port"):
        _catable_parts(str(tmp_path / pkg))
    rc, out, err, made = both(tmp_path, (JCAT.main, TCAT.main),
                              CAT_CASES[case])
    if case.startswith("join"):
        joined = made.get("joined.br", out)
        assert rc == 0
        assert oracle.decompress(joined, len(DATA) + 1) == DATA[:24_000]
    elif case == "one_input":
        assert rc == 0 and oracle.decompress(made["joined.br"]) == \
            DATA[:6_000]
    elif case in ("too_few_files", "no_files"):
        assert (rc, err) == (2, "need an output and at least one input\n")
    elif case == "unknown_flag":
        assert (rc, err) == (2, "unknown flag -x\n")
    elif case == "dash_output_is_an_unknown_flag":
        assert (rc, out, err) == (2, b"", "unknown flag -\n")
    elif case == "help":
        assert rc == 0 and out.startswith(b"usage: catbrotli")


def test_modules_run_as_scripts(tmp_path):
    """python -m brotli_tpu_torch.cli.brotli_cli and ...catbrotli_cli:
    the same bytes as main(argv) in this process."""
    d = str(tmp_path)
    files(d)
    parts = _catable_parts(d)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = os.path.join(d, "out.br")
    subprocess.run([sys.executable, "-m", "brotli_tpu_torch.cli.brotli_cli",
                    "-c", "-q5", os.path.join(d, "in.txt"), out],
                   check=True, env=env, cwd=d, timeout=120)
    assert open(out, "rb").read() == compress(DATA, quality=5)
    joined = os.path.join(d, "joined.br")
    subprocess.run([sys.executable, "-m",
                    "brotli_tpu_torch.cli.catbrotli_cli", joined, *parts],
                   check=True, env=env, cwd=d, timeout=120)
    assert oracle.decompress(open(joined, "rb").read()) == DATA[:24_000]
