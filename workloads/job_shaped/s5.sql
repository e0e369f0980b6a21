-- Synthetic JOB-shaped query s5, modelled on JOB family 5 (Leis et al.,
-- VLDB 2015): two LIKEs on one column and IN lists. Written for this
-- repository; not a JOB query.
SELECT MIN(t.title) AS european_movie
FROM company_type AS ct,
     info_type AS it,
     movie_companies AS mc,
     movie_info AS mi,
     title AS t
WHERE ct.kind = 'distributors'
  AND mc.note LIKE '%(theatrical)%'
  AND mc.note LIKE '%(Germany)%'
  AND it.info IN ('languages', 'countries')
  AND mi.info IN ('German', 'Austria', 'Switzerland', 'Germany')
  AND t.production_year > 2000
  AND t.id = mi.movie_id
  AND t.id = mc.movie_id
  AND mc.movie_id = mi.movie_id
  AND ct.id = mc.company_type_id
  AND it.id = mi.info_type_id;
