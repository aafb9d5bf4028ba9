"""Share of the SDS step's compacted sample stream that held real samples
(%): 100 x sds.samples_valid / sds.samples_slots, the program's counters
over the whole run: set-up, window and traced epoch. The grid is refreshed
from its initial value as the run goes, so the reading depends on the
run's length (--seconds)."""
from benchmark import program_spans


def read(run):
    return program_spans.sample_fill("sds")
