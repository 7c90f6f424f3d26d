"""RPC layer: the typed rejection the tablet layer raises (the messenger
itself comes with the rpc part of ROADMAP queue A item 7)."""
