"""Megabytes a frame copied between host and card by the low-delay
encoder over the window: `transfer_mb_per_frame`'s reading (the change of
the counters `upload_bytes` and `fetch_bytes`), taken in the low-delay
cell.  Here the copies are the source picture up
(`pipeline.upload_picture`) and the slices with their 61-base tables down
(`encoder/lowdelay.fetch`): 30.9792 MB a 1080p 4:2:2 10-bit picture.  It
is a metric of its own because the accepted one is compared in the
long-GOP cell alone, and a program that counts no low-delay copy leaves
it out of the line."""

from metrics.transfer_mb_per_frame import read  # noqa: F401
