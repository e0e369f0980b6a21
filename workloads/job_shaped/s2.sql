-- Synthetic JOB-shaped query s2, modelled on JOB family 2 (Leis et al.,
-- VLDB 2015): keyword and company country. Written for this repository;
-- not a JOB query.
SELECT MIN(t.title) AS movie_title
FROM company_name AS cn,
     keyword AS k,
     movie_companies AS mc,
     movie_keyword AS mk,
     title AS t
WHERE cn.country_code = '[fr]'
  AND k.keyword = 'based-on-novel'
  AND cn.id = mc.company_id
  AND mc.movie_id = t.id
  AND t.id = mk.movie_id
  AND mk.keyword_id = k.id
  AND mc.movie_id = mk.movie_id;
