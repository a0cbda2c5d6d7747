"""One file per hand-written kernel: KERNEL, the substring of its
`__global__` name in a device trace; CALLS, the (module, attribute) of the
port's Python function whose every call launches it; and bound(args,
kwargs) -> (seconds, side), the least time an H100 SXM could take for that
call from the call's own arguments. The counts are frozen copies of
chip_smoke.py's (commit dd78b9c), so a later change to the port cannot
move them."""
