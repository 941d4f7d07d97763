"""waltz: networking (ref: src/waltz/).  The port holds the aio burst
interface and the UDP sockets backend the shred tile's retransmit sends
use."""
