"""The benchmark's own machinery: finding configurations, traffic mixes,
drivers and metric readers by name, the traffic generator, probes around
the calls into the program, the profile reader and the comparison that
decides ``correct``."""
