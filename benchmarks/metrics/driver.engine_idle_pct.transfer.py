"""Share of the traced window in which the card ran nothing while the host
was inside a TransferEngine call (`transfer.video` span), in %. The rest of
`device.idle_pct.transfer` is idle while the caller held the host."""

from benchmarks import spans


def read(records):
    idle = spans.idle_seconds(records["trace"], "transfer.video")
    window = records["trace"]["window_s"]
    return None if idle is None or window <= 0 else 100.0 * idle / window
