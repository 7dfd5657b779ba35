"""Share of the samples the flows computed in the traced window that were
asked for: the program's `vocode.samples_useful` (true lengths) over
`vocode.samples_computed` (rows times bucket samples, bucket padding and
the pad rows of ragged groups included)."""

from perfbench import spans


def read(run):
    rec = spans.program_record()
    if rec is None or not rec.counts.get("vocode.samples_computed"):
        return None
    return (100.0 * rec.counts.get("vocode.samples_useful", 0)
            / rec.counts["vocode.samples_computed"])
