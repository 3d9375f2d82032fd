"""The IR side channel of the host encoder.

A copy of brotli_tpu/utils/ir.py: the IR vocabulary (PredictionMode,
BlockSwitch{Literal,Command,Distance}, Copy, Dict, Literal; reference
interface.rs Command enum); ir_from_commands, which turns one
metablock's resolved commands into that IR for compress()'s
metablock_callback (reference LogMetaBlock); and the CLI's text dump
(-i; reference bin/util.rs:85 write_one):

    prediction <mode> lcontextmap ... dcontextmap ...
    ltype <t> <stride> / ctype <t> / dtype <t>
    copy <n> from <d>
    dict <n> word <size>,<id> <hex> func <f> <hex>
    insert <n> <hex>
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.dictionary import get_dictionary


@dataclass
class PredictionMode:
    """Reference interface.rs PredictionModeContextMap (:109-250): the
    context maps plus embedded adaptation-speed and mixing metadata
    (set by -speed= / -findspeed / -findprior; IR-only, not wire)."""
    mode: int = 0
    literal_context_map: list = field(default_factory=list)
    distance_context_map: list = field(default_factory=list)
    cm_speed: tuple = (16, 8192)        # (inc, max) context-map model
    stride_speed: tuple = (16, 8192)    # (inc, max) stride model
    prior_bitmask: int | None = None    # per-context CM-family mask
    mix_weight: float | None = None     # ADV 2-model blend weight


@dataclass
class BlockSwitchLiteral:
    block_type: int = 0
    stride: int = 0


@dataclass
class BlockSwitchCommand:
    block_type: int = 0


@dataclass
class BlockSwitchDistance:
    block_type: int = 0


@dataclass
class Copy:
    num_bytes: int = 0
    distance: int = 0


@dataclass
class Dict:
    word_size: int = 0
    word_id: int = 0
    transform: int = 0
    final_size: int = 0


@dataclass
class Literal:
    data: bytes = b""
    high_entropy: bool = False
    # external-literal-probability feature (reference interface.rs
    # :378-420 FeatureFlagSliceType): caller-provided per-literal
    # probabilities riding the IR for downstream recompression research
    probs: bytes | None = None


MODE_NAMES = {0: "lsb6", 1: "msb6", 2: "utf8", 3: "sign"}


def _switch_types(switch_plan, ntypes):
    """Decode the wire type symbols back to block-type ids."""
    cur, prev = 0, 1
    out = []
    for s in switch_plan["type_syms"]:
        if s == 0:
            new = prev
        elif s == 1:
            new = (cur + 1) % ntypes
        else:
            new = s - 2
        prev, cur = cur, new
        out.append((new, s))
    return out


def ir_from_commands(data: np.ndarray, start: int, cmds, plan=None,
                     pos_offset: int = 0, window_size: int = 1 << 62,
                     lit_probs=None):
    """Build the IR command list for one metablock from resolved
    commands (the encoder-side channel, reference process_command_queue,
    brotli_bit_stream.rs:220-418).  With a MetaBlockPlan, block-switch
    records are interleaved at their firing points."""
    out = []
    lit_switches = []
    cmd_switches = []
    if plan is not None:
        out.append(PredictionMode(
            mode=plan.context_mode,
            literal_context_map=list(map(int, plan.cmap_l)),
            distance_context_map=list(map(int, plan.cmap_d))))
        if plan.lit_switch:
            at = plan.lit_switch["switch_at"]
            types = [b for b, _ in _switch_types(plan.lit_switch,
                                                 plan.lit_ntypes)]
            lit_switches = list(zip(map(int, at), types))
        if plan.cmd_switch:
            at = plan.cmd_switch["switch_at"]
            types = [b for b, _ in _switch_types(plan.cmd_switch,
                                                 plan.cmd_ntypes)]
            cmd_switches = list(zip(map(int, at), types))
    lit_i = 0
    cmd_i = 0
    n_lit_seen = 0
    pos = start
    abs_pos = pos_offset
    for i in range(len(cmds)):
        while cmd_i < len(cmd_switches) and cmd_switches[cmd_i][0] == i:
            out.append(BlockSwitchCommand(cmd_switches[cmd_i][1]))
            cmd_i += 1
        il = int(cmds.insert_len[i])
        cl = int(cmds.copy_len[i])
        av = int(cmds.copy_advance[i])
        d = int(cmds.distance[i])
        if il:
            while (lit_i < len(lit_switches)
                   and n_lit_seen <= lit_switches[lit_i][0]
                   < n_lit_seen + il):
                out.append(BlockSwitchLiteral(lit_switches[lit_i][1], 0))
                lit_i += 1
            n_lit_seen += il
            out.append(Literal(
                bytes(data[pos:pos + il]),
                probs=bytes(lit_probs[pos:pos + il])
                if lit_probs is not None else None))
        pos += il
        abs_pos += il
        if cl:
            max_distance = min(abs_pos, window_size)
            if d > max_distance:
                word_id = d - max_distance - 1
                dic = get_dictionary()
                sb = int(dic.size_bits_by_length[cl])
                out.append(Dict(word_size=cl, word_id=word_id & ((1 << sb)
                                                                 - 1),
                                transform=word_id >> sb,
                                final_size=av))
            else:
                out.append(Copy(num_bytes=cl, distance=d))
            pos += av
            abs_pos += av
    return out


def format_ir(commands) -> str:
    """Reference write_one text format (bin/util.rs:85)."""
    lines = []
    dic = get_dictionary()
    for c in commands:
        if isinstance(c, PredictionMode):
            lcm = "".join(f" {v}" for v in c.literal_context_map)
            dcm = "".join(f" {v}" for v in c.distance_context_map)
            extra = (f" cmspeedinc {c.cm_speed[0]} cmspeedmax "
                     f"{c.cm_speed[1]} stspeedinc {c.stride_speed[0]} "
                     f"stspeedmax {c.stride_speed[1]}")
            if c.prior_bitmask is not None:
                extra += f" priormask {c.prior_bitmask:#06x}"
            if c.mix_weight is not None:
                extra += f" mixweight {c.mix_weight}"
            lines.append(f"prediction {MODE_NAMES.get(c.mode, '?')} "
                         f"lcontextmap{lcm} dcontextmap{dcm}{extra}")
        elif isinstance(c, BlockSwitchLiteral):
            lines.append(f"ltype {c.block_type} {c.stride}")
        elif isinstance(c, BlockSwitchCommand):
            lines.append(f"ctype {c.block_type}")
        elif isinstance(c, BlockSwitchDistance):
            lines.append(f"dtype {c.block_type}")
        elif isinstance(c, Copy):
            lines.append(f"copy {c.num_bytes} from {c.distance}")
        elif isinstance(c, Dict):
            raw = dic.word(c.word_size, c.word_id)
            xform = dic.transformed(c.word_size, c.word_id, c.transform)
            lines.append(
                f"dict {c.final_size} word {c.word_size},{c.word_id} "
                f"{raw.hex()} func {c.transform} {xform.hex()}")
        elif isinstance(c, Literal):
            kind = "rndins" if c.high_entropy else "insert"
            lines.append(f"{kind} {len(c.data)} {c.data.hex()}")
    return "\n".join(lines) + "\n"


def dump_ir(data: bytes, quality: int = 9, lgwin: int = 22,
            cm_speed=None, stride_speed=None,
            prior_bitmask=None, mix_weight=None) -> str:
    """Encode `data` through the live metablock callback (quality
    capped at 9) and return the IR dump (CLI -i); "" for empty input.
    The leading PredictionMode record is a default one carrying only
    the speed and prior metadata (-speed= / -findspeed / -findprior)."""
    from ..encode.encoder import compress

    if len(data) == 0:
        return ""
    blocks = []
    compress(bytes(data), quality=min(quality, 9), lgwin=lgwin,
             metablock_callback=lambda ir, region: blocks.append(ir))
    pm = PredictionMode()
    if cm_speed is not None:
        pm.cm_speed = tuple(cm_speed)
    if stride_speed is not None:
        pm.stride_speed = tuple(stride_speed)
    pm.prior_bitmask = prior_bitmask
    pm.mix_weight = mix_weight
    out = [pm]
    for ir in blocks:
        out.extend(ir)
    return format_ir(out)
