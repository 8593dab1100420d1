"""How a traffic mix is driven through the port, one module a kind,
named by the traffic file's ``driver`` key."""
