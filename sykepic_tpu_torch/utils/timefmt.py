"""IFCB sample-name timestamp parsing (reference ``sykepic/utils/ifcb.py:16-43``).

IFCB sample names encode UTC acquisition time: ``D20180703T093453_IFCB114``
-> 2018-07-03 09:34:53+00:00. Characters ``[1:16]`` hold ``YYYYMMDDTHHMMSS``.
"""

import datetime


def sample_to_datetime(sample: str, isoformat: bool = False):
    """Parse an IFCB sample name into an aware UTC datetime.

    Matches reference ``ifcb.py:38-43``: characters 1..15 of the sample name,
    ``%Y%m%dT%H%M%S``, tz set to UTC. With ``isoformat=True`` returns the ISO
    8601 string (used for the ``Time`` index of classification outputs,
    reference ``compute/classification.py:139-140``).
    """
    timestamp = datetime.datetime.strptime(sample[1:16], "%Y%m%dT%H%M%S")
    aware = timestamp.replace(tzinfo=datetime.timezone.utc)
    if isoformat:
        return aware.isoformat()
    return aware
