"""Share of the window (%) in the static-dictionary probe of
compress_gpu's host leg: the program's host_parse.dict_probe spans (the
candidate arrays and static_dict.add_dictionary_matches).  Layer:
gpu_path._host_parse."""

from program_spans import share

COUNTERS = "stats"


def read(ctx):
    return share(ctx, "host_parse.dict_probe")
