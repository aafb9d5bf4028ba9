"""Share of the band term's fixed candidate slots that lie in the band (%):
100 x band.samples_valid / band.samples_slots, the program's counters over
the whole run, real and SDS steps alike (the real steps are 10 of an
epoch's 11). The exact ladder's slots are its P*N rungs and the mask is
its outside_radius filter; the reuse form's are the sample stream's and
the mask is the samples within trunc/2 of the rendered depth."""
from benchmark import program_spans


def read(run):
    return program_spans.sample_fill("band")
