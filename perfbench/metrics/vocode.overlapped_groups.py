"""Share of the groups `vocode_many` ran in the traced window that were
read back and deemphasized while the next group's flows were already
enqueued on the card: the program's `vocode.groups_overlapped` over
`vocode.groups`.  A program that does not pipeline its groups counts
neither and reports nothing."""

from perfbench import spans


def read(run):
    rec = spans.program_record()
    if rec is None or not rec.counts.get("vocode.groups"):
        return None
    return (100.0 * rec.counts.get("vocode.groups_overlapped", 0)
            / rec.counts["vocode.groups"])
