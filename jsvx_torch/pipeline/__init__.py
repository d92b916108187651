"""Host pipeline of the port: compact parse, wire, GOP loop, transcode."""
