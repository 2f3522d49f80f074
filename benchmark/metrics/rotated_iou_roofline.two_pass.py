"""``rotated_iou_roofline`` in CoAlign's two-pass cell, whose end-to-end
metrics are its own (``*.two_pass``: its host-bound request spreads more
from run to run than the other cells' do)."""

from benchmark.yardstick.loader import load

read = load("metrics", "rotated_iou_roofline").read
