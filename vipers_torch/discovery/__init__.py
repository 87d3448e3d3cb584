"""LOST object discovery: batched core, CorLoc, and the feature driver."""
