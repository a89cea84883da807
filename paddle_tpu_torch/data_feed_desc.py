"""``DataFeedDesc``, the text-protobuf descriptor of a MultiSlot data
feed (mirrors ``paddle_tpu/data_feed_desc.py``, all of it; the
reference's ``python/paddle/fluid/data_feed_desc.py`` and
``framework/data_feed.proto``).

A purpose-built parser reads the text format into plain dicts (the
message is two levels deep: scalar fields and ``multi_slot_desc {
slots { ... } }``), and ``desc()`` writes it back in the same format."""

__all__ = ["DataFeedDesc"]


def _parse_scalar(tok):
    t = tok.strip()
    if t.startswith('"') and t.endswith('"'):
        return t[1:-1]
    if t in ("true", "false"):
        return t == "true"
    try:
        return int(t)
    except ValueError:
        try:
            return float(t)
        except ValueError:
            return t


def _parse_block(lines, i):
    """Parse `key: value` / `key { ... }` lines until the closing '}'."""
    out = {}
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        if line == "}":
            return out, i
        if line.endswith("{"):
            key = line[:-1].strip()
            sub, i = _parse_block(lines, i)
            out.setdefault(key, []).append(sub)
        elif ":" in line:
            key, _, val = line.partition(":")
            out[key.strip()] = _parse_scalar(val)
    return out, i


def _fmt_scalar(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"%s"' % v
    return str(v)


def _serialize(d, indent=0):
    pad = "  " * indent
    lines = []
    for k, v in d.items():
        if isinstance(v, list):
            for sub in v:
                lines.append("%s%s {" % (pad, k))
                lines.append(_serialize(sub, indent + 1))
                lines.append("%s}" % pad)
        else:
            lines.append("%s%s: %s" % (pad, k, _fmt_scalar(v)))
    return "\n".join(lines)


class DataFeedDesc:
    """Reference :82 — initialize from a proto text file, then tune
    batch size / dense / used slots before handing to a trainer."""

    def __init__(self, proto_file):
        with open(proto_file) as f:
            lines = f.read().splitlines()
        self.proto_desc, _ = _parse_block(lines, 0)
        self.proto_desc.setdefault("pipe_command", "cat")
        self._name_to_slot = {}
        for msd in self.proto_desc.get("multi_slot_desc", []):
            for slot in msd.get("slots", []):
                self._name_to_slot[slot.get("name")] = slot

    def set_batch_size(self, batch_size):
        self.proto_desc["batch_size"] = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        """Mark slots dense (fixed-shape float) — all others stay sparse
        (reference :128)."""
        if self.proto_desc.get("name") != "MultiSlotDataFeed":
            raise ValueError(
                "Only MultiSlotDataFeed needs set_dense_slots")
        for name in dense_slots_name:
            self._name_to_slot[name]["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        """Mark which slots are consumed by the model (reference :173)."""
        if self.proto_desc.get("name") != "MultiSlotDataFeed":
            raise ValueError(
                "Only MultiSlotDataFeed needs set_use_slots")
        for msd in self.proto_desc.get("multi_slot_desc", []):
            for slot in msd.get("slots", []):
                slot["is_used"] = slot.get("name") in use_slots_name

    def desc(self):
        """Text-format serialization (reference :218)."""
        return _serialize(self.proto_desc) + "\n"
