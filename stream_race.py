"""``chip_smoke.py``'s copy-stream race probe with its control, on one card.

    python3 stream_race.py

``HostDataset.blocks`` copies each block on a side stream.  Its copies
must wait for the compute stream before the first one, because a new
stream's buffers may be memory that work still queued there reads.
``chip_smoke.stream_race_probe`` keeps the compute stream busy at each
stream's last blocks and counts the block sums that differ from their
host rows.  This script runs it with the wait and, as the control,
without it (``torch.cuda.Stream.wait_stream`` replaced by a no-op for
that run), at ``chip_smoke.RACE_BUSY_FROM`` and with every block held.
The probe is sound when the control sees the race and the run with the
wait does not.  Prints one line a run: (sums off, blocks).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("stream_race.py needs a CUDA device")
    real = torch.cuda.Stream.wait_stream
    for busy in (cs.RACE_BUSY_FROM, 0):
        cs.RACE_BUSY_FROM = busy
        print(f"busy from {busy}, with the wait:", cs.stream_race_probe(port), flush=True)
        torch.cuda.Stream.wait_stream = lambda self, other: None
        try:
            print(f"busy from {busy}, without the wait (control):",
                  cs.stream_race_probe(port), flush=True)
        finally:
            torch.cuda.Stream.wait_stream = real


if __name__ == "__main__":
    main()
