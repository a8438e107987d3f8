"""Runtime utilities: logging, panicless wrappers, post queue, timers,
operation monitoring, crontab and async job groups.

Reference parity: engine/gwlog, engine/gwutils, engine/post, engine/opmon,
engine/crontab, engine/async (see SURVEY.md §2.1).
"""
