"""The judgement that decides ``correct``: each number that a traffic
kind's ``numbers`` compares (``kinds/<kind>.py``) against its limit in
``limits/<workload>.json``, where it stands with the readings it was set
from, and no request of the window failed.
"""

import math


def limits_for(cell):
    """{number: limit} from the cell's limits file."""
    return {name: float(entry["limit"]) for name, entry in cell.limits.items()}


def judge(numbers, limits, failed):
    """(correct, {name: {"value", "limit"}}): every number finite and at most
    its limit, a number without a limit never correct, and no failed solve
    or other request."""
    table = {"failed": {"value": failed, "limit": 0}}
    ok = failed == 0
    for name, value in numbers.items():
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) and (
            value <= limit)
    return ok, table
