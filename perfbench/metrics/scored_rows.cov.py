'''
``scored_rows.cov``: the rows the exact scoring S1 takes a traced sample
of a coverage scan (counter ``scan.scored``): how much of each batch the
candidate screen passes on.
'''


def read(record):
    samples = record['program']
    if not samples or not any('scan.scored' in p['counts']
                              for p in samples):
        return None
    return sum(p['counts'].get('scan.scored', 0)
               for p in samples) / len(samples)
