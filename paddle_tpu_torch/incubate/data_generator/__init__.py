"""DataGenerator (mirrors ``paddle_tpu/incubate/data_generator/__init__.py``,
all of it; the reference's ``python/paddle/fluid/incubate/data_generator``):
the user-subclassed converter from raw log lines to the MultiSlot text
records the dataset reads (``dataset.py``, ``native/src/multislot.cc``).

Users override ``generate_sample(line)`` (→ an iterator of
``[(slot_name, [feasign...]), ...]``) and optionally
``generate_batch(samples)``; ``run_from_stdin`` / ``run_from_memory``
drive the conversion, writing ``<len> id...`` per slot."""

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32
        self._line_limit = None

    def _set_line_limit(self, line_limit):
        if not isinstance(line_limit, int) or line_limit < 1:
            raise ValueError("line_limit must be a positive int")
        self._line_limit = line_limit

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def run_from_memory(self):
        """Drive generate_sample(None) → generate_batch → stdout."""
        batch_samples = []
        for user_sample in self.generate_sample(None)():
            if user_sample is None:
                continue
            batch_samples.append(user_sample)
            if len(batch_samples) == self.batch_size_:
                for sample in self.generate_batch(batch_samples)():
                    sys.stdout.write(self._gen_str(sample))
                batch_samples = []
        if batch_samples:
            for sample in self.generate_batch(batch_samples)():
                sys.stdout.write(self._gen_str(sample))

    def run_from_stdin(self):
        """One raw input line per generate_sample call (streaming)."""
        batch_samples = []
        for n, line in enumerate(sys.stdin, 1):
            if self._line_limit and n > self._line_limit:
                break
            for user_sample in self.generate_sample(line)():
                if user_sample is None:
                    continue
                batch_samples.append(user_sample)
                if len(batch_samples) == self.batch_size_:
                    for sample in self.generate_batch(batch_samples)():
                        sys.stdout.write(self._gen_str(sample))
                    batch_samples = []
        if batch_samples:
            for sample in self.generate_batch(batch_samples)():
                sys.stdout.write(self._gen_str(sample))

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")

    def generate_sample(self, line):
        raise NotImplementedError(
            "generate_sample() must be overridden: return a zero-arg "
            "iterator of [(slot_name, [feasign, ...]), ...]")

    def generate_batch(self, samples):
        """Default: pass samples through one by one."""

        def local_iter():
            for sample in samples:
                yield sample

        return local_iter


def _check_sample(line):
    if not isinstance(line, (list, tuple)):
        raise ValueError(
            "the output of process() must be list or tuple, e.g. "
            "[('words', [1926, 8, 17]), ('label', [1])]")


class MultiSlotStringDataGenerator(DataGenerator):
    def _gen_str(self, line):
        """[(name, [str_id...]), ...] → '<len> id... <len> id...\\n'."""
        _check_sample(line)
        parts = []
        for name, elements in line:
            parts.append(str(len(elements)))
            parts.extend(elements)
        return " ".join(parts) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    def _gen_str(self, line):
        """Typed variant: tracks per-slot uint64/float in _proto_info
        (a float element anywhere flips the slot to float, as in the
        reference's progressive type refinement)."""
        _check_sample(line)
        if self._proto_info is None:
            self._proto_info = [(name, "uint64") for name, _ in line]
        elif len(self._proto_info) != len(line):
            raise ValueError(
                "field count changed between samples: %d vs %d"
                % (len(self._proto_info), len(line)))
        parts = []
        for i, (name, elements) in enumerate(line):
            if not elements:
                raise ValueError(
                    "slot %r is empty — pad it in process()" % name)
            if name != self._proto_info[i][0]:
                raise ValueError(
                    "field name changed between samples: %r vs %r"
                    % (self._proto_info[i][0], name))
            parts.append(str(len(elements)))
            for elem in elements:
                if isinstance(elem, float):
                    self._proto_info[i] = (name, "float")
                elif not isinstance(elem, int):
                    raise ValueError(
                        "element of slot %r must be int or float, got %r"
                        % (name, type(elem)))
                parts.append(str(elem))
        return " ".join(parts) + "\n"
