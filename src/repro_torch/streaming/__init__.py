# Streaming mutable index over the proximity graph (port of
# ``repro.streaming``): a slot-pool corpus of fixed capacity whose rows live
# on the device, search-guided inserts with degree-bounded edge patches,
# tombstone deletes masked by every search path like a failed constraint,
# and consolidation that splices dead vertices out and frees their slots.
from repro_torch.streaming.consolidate import consolidate
from repro_torch.streaming.mutate import insert_one, patch_neighbor_row
from repro_torch.streaming.slots import IndexSnapshot, SlotPool, StreamingIndex

__all__ = [
    "IndexSnapshot",
    "SlotPool",
    "StreamingIndex",
    "consolidate",
    "insert_one",
    "patch_neighbor_row",
]
