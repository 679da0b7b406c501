"""stage_misses_per_msm: the program's stage spans "stage <name>:
<outcome>" whose outcome is not `replay` (a graph captured, or a stage run
eagerly), per traced MSM. A count: 0 where every stage of a warm call
replays its graph. Layer: utils.cache, stage graphs."""
import re

STAGE = re.compile(r"stage \S+: (replay|capture|eager)")


def read(tr):
    outcomes = [(m.group(1), len(times)) for label, times in tr.phases.items()
                if (m := STAGE.fullmatch(label))]
    if not outcomes:
        return None
    return sum(n for outcome, n in outcomes if outcome != "replay") / tr.msms
